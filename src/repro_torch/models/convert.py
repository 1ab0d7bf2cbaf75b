"""Parameters of the reference package in this package's modules, and
back.

The reference keeps its parameters (and its optimizer state) as a tree
of arrays stacked per layer kind (``repro/models/transformer.py:
init_params``): ``tree["layers"]["ssm_none"]["mixer"]["wz"]`` holds the
``wz`` of every ``ssm_none`` layer along a leading axis, and a hybrid
model (jamba) has one such stack per kind (``ssm_mlp``, ``ssm_moe``,
``attn_mlp``). This package keeps one module per layer, so
``layers.3.mixer.wz`` is its kind's stack's entry at the layer's index
within the kind. :func:`reference_path` maps one name to the other;
:func:`from_reference` builds the modules from a reference tree (numpy
leaves, any float dtype, bf16 included) and :func:`to_reference` stacks
named tensors back into the reference's tree, which is what checkpoints
hold. Nothing here imports the reference or JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .attention import GQA, MLA
from .common import MLP, ArchConfig, Embed, Norm, check_ported
from .moe import MoE
from .ssm import SSM
from .transformer import Block, Transformer, layer_schedule


def _t(a, cfg: ArchConfig, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=cfg.pdtype)


def from_reference(params, cfg: ArchConfig, device="cuda") -> Transformer:
    """The reference parameter tree (numpy leaves) as a
    :class:`Transformer` on ``device``, in ``cfg.param_dtype``."""
    check_ported(cfg)
    sched, _, idx_in_kind = layer_schedule(cfg)
    layers = []
    for kind, i in zip(sched, idx_in_kind):
        mixer_kind, ffn_kind = kind.split("_")
        stack = params["layers"][kind]
        get = lambda tree, name: _t(tree[name][i], cfg, device)
        mx = stack["mixer"]
        norm1 = Norm(get(stack["norm1"], "scale"))
        if mixer_kind == "ssm":
            mixer = SSM(**{k: get(mx, k) for k in SSM.NAMES})
        elif cfg.mla:
            mixer = MLA(*(get(mx, w) for w in MLA.NAMES))
        else:
            bias = {k: get(mx, k) for k in ("bq", "bk", "bv") if k in mx}
            mixer = GQA(*(get(mx, w) for w in ("wq", "wk", "wv", "wo")),
                        **bias)
        if ffn_kind == "none":
            layers.append(Block(norm1, mixer))
            continue
        ffn = stack["ffn"]
        mlp = lambda tree: MLP(get(tree, "w1"), get(tree, "w2"),
                               get(tree, "w3") if "w3" in tree else None)
        if ffn_kind == "moe":
            ffn_mod = MoE(*(get(ffn, w) for w in ("router", "w1", "w2", "w3")),
                          mlp(ffn["shared"]) if "shared" in ffn else None)
        else:
            ffn_mod = mlp(ffn)
        layers.append(Block(norm1, mixer, Norm(get(stack["norm2"], "scale")),
                            ffn_mod))
    emb = params["embed"]
    return Transformer(Embed(_t(emb["embed"], cfg, device),
                             _t(emb["unembed"], cfg, device)),
                       layers,
                       Norm(_t(params["final_norm"]["scale"], cfg, device)))


def reference_path(name: str,
                   cfg: ArchConfig) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``"layers.3.mixer.wz"`` -> ``(("layers", "ssm_none", "mixer",
    "wz"), 3)``: the key path of the reference's stacked leaf and the
    layer's index in it; ``(path, None)`` for a leaf outside the
    layers."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tuple(parts), None
    sched, _, idx_in_kind = layer_schedule(cfg)
    i = int(parts[1])
    return ("layers", sched[i], *parts[2:]), idx_in_kind[i]


def to_reference(named: Mapping[str, torch.Tensor],
                 cfg: ArchConfig) -> Dict[str, Any]:
    """Named tensors (``module.named_parameters()`` names, or optimizer
    state keyed the same way) as the reference's nested tree, per-layer
    leaves stacked along a new leading axis. The leaves keep their dtype
    and device (pass CPU tensors to build a checkpoint)."""
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        path, idx = reference_path(name, cfg)
        if idx is None:
            _put(tree, path, t)
        else:
            stacks.setdefault(path, {})[idx] = t
    for path, items in stacks.items():
        _put(tree, path, torch.stack([items[i] for i in sorted(items)]))
    return tree


def named_from_reference(tree: Mapping[str, Any], names,
                         cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of :func:`to_reference` for the given names: each
    name's leaf, or its layer's entry of a stacked leaf (numpy arrays or
    tensors, as the tree holds them)."""
    out = {}
    for name in names:
        path, idx = reference_path(name, cfg)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = leaf if idx is None else leaf[idx]
    return out


def _put(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value

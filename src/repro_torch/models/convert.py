"""Parameters of the reference package in this package's modules, and
back.

The reference keeps its parameters (and its optimizer state) as a tree
of arrays stacked per layer kind (``repro/models/transformer.py:
init_params``): ``tree["layers"]["ssm_none"]["mixer"]["wz"]`` holds the
``wz`` of every ``ssm_none`` layer along a leading axis, and a hybrid
model (jamba) has one such stack per kind (``ssm_mlp``, ``ssm_moe``,
``attn_mlp``). This package keeps one module per layer, so
``layers.3.mixer.wz`` is its kind's stack's entry at the layer's index
within the kind. The encoder-decoder (``repro/models/encdec.py``)
stacks its ``enc_layers`` and ``dec_layers`` as they come, so
``dec_layers.3.cross_attn.wq`` is entry 3 of
``tree["dec_layers"]["cross_attn"]["wq"]``; LayerNorms add a ``bias``
beside each ``scale``, the VLM an ``img_proj`` leaf, and tied embeddings
drop ``unembed``. :func:`reference_path` maps one name to the other;
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
from .encdec import DecBlock, EncBlock, EncDec
from .moe import MoE
from .ssm import SSM
from .transformer import Block, Transformer, layer_schedule

#: the encoder-decoder's layer stacks, indexed by the layer itself
_STACKS = ("enc_layers", "dec_layers")


def _t(a, cfg: ArchConfig, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=cfg.pdtype)


def _norm(get, tree) -> Norm:
    return Norm(get(tree, "scale"),
                get(tree, "bias") if "bias" in tree else None)


def _gqa(get, tree) -> GQA:
    bias = {k: get(tree, k) for k in ("bq", "bk", "bv") if k in tree}
    return GQA(*(get(tree, w) for w in ("wq", "wk", "wv", "wo")), **bias)


def _mlp(get, tree) -> MLP:
    return MLP(get(tree, "w1"), get(tree, "w2"),
               get(tree, "w3") if "w3" in tree else None)


def _embed(params, cfg: ArchConfig, device) -> Embed:
    emb = params["embed"]
    return Embed(_t(emb["embed"], cfg, device),
                 _t(emb["unembed"], cfg, device) if "unembed" in emb
                 else None)


def _encdec_from_reference(params, cfg: ArchConfig, device) -> EncDec:
    whole = lambda tree, name: _t(tree[name], cfg, device)
    enc, dec = [], []
    for i in range(cfg.n_enc_layers):
        get = lambda tree, name: _t(tree[name][i], cfg, device)
        st = params["enc_layers"]
        enc.append(EncBlock(_norm(get, st["norm1"]), _gqa(get, st["attn"]),
                            _norm(get, st["norm2"]), _mlp(get, st["ffn"])))
    for i in range(cfg.n_layers):
        get = lambda tree, name: _t(tree[name][i], cfg, device)
        st = params["dec_layers"]
        dec.append(DecBlock(_norm(get, st["norm1"]),
                            _gqa(get, st["self_attn"]),
                            _norm(get, st["norm_x"]),
                            _gqa(get, st["cross_attn"]),
                            _norm(get, st["norm2"]), _mlp(get, st["ffn"])))
    return EncDec(_embed(params, cfg, device), enc, dec,
                  _norm(whole, params["enc_norm"]),
                  _norm(whole, params["dec_norm"]))


def from_reference(params, cfg: ArchConfig, device="cuda"):
    """The reference parameter tree (numpy leaves) as a
    :class:`Transformer` (or, for the encoder-decoder, an
    :class:`EncDec`) on ``device``, in ``cfg.param_dtype``."""
    check_ported(cfg)
    if cfg.encoder_decoder:
        return _encdec_from_reference(params, cfg, device)
    sched, _, idx_in_kind = layer_schedule(cfg)
    layers = []
    for kind, i in zip(sched, idx_in_kind):
        mixer_kind, ffn_kind = kind.split("_")
        stack = params["layers"][kind]
        get = lambda tree, name: _t(tree[name][i], cfg, device)
        mx = stack["mixer"]
        norm1 = _norm(get, stack["norm1"])
        if mixer_kind == "ssm":
            mixer = SSM(**{k: get(mx, k) for k in SSM.NAMES})
        elif cfg.mla:
            mixer = MLA(*(get(mx, w) for w in MLA.NAMES))
        else:
            mixer = _gqa(get, mx)
        if ffn_kind == "none":
            layers.append(Block(norm1, mixer))
            continue
        ffn = stack["ffn"]
        if ffn_kind == "moe":
            ffn_mod = MoE(*(get(ffn, w) for w in ("router", "w1", "w2", "w3")),
                          _mlp(get, ffn["shared"]) if "shared" in ffn
                          else None)
        else:
            ffn_mod = _mlp(get, ffn)
        layers.append(Block(norm1, mixer, _norm(get, stack["norm2"]),
                            ffn_mod))
    whole = lambda tree, name: _t(tree[name], cfg, device)
    return Transformer(_embed(params, cfg, device), layers,
                       _norm(whole, params["final_norm"]),
                       _t(params["img_proj"], cfg, device)
                       if "img_proj" in params else None)


def reference_path(name: str,
                   cfg: ArchConfig) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``"layers.3.mixer.wz"`` -> ``(("layers", "ssm_none", "mixer",
    "wz"), 3)``: the key path of the reference's stacked leaf and the
    layer's index in it (``"dec_layers.3.norm_x.bias"`` -> ``(("dec_layers",
    "norm_x", "bias"), 3)``); ``(path, None)`` for a leaf outside the
    layers."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        return (parts[0], *parts[2:]), int(parts[1])
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

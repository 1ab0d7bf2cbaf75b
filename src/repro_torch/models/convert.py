"""Weights of the reference package, converted into this package's
modules.

The reference keeps its parameters as a tree of arrays stacked per
layer kind (``repro/models/transformer.py:init_params``). The caller
hands that tree over as numpy arrays (any float dtype, bf16 included);
nothing here imports the reference or JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .attention import GQA
from .common import MLP, ArchConfig, Embed, Norm, check_dense
from .transformer import Block, Transformer

_KIND = "attn_mlp"          # the dense decoder's one layer kind


def _t(a, cfg: ArchConfig, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=cfg.pdtype)


def from_reference(params, cfg: ArchConfig, device="cuda") -> Transformer:
    """The reference parameter tree (numpy leaves) as a
    :class:`Transformer` on ``device``, in ``cfg.param_dtype``."""
    check_dense(cfg)
    stack = params["layers"][_KIND]
    layers = []
    for i in range(cfg.n_layers):
        mx, ffn = stack["mixer"], stack["ffn"]
        bias = {name: _t(mx[name][i], cfg, device)
                for name in ("bq", "bk", "bv") if name in mx}
        layers.append(Block(
            Norm(_t(stack["norm1"]["scale"][i], cfg, device)),
            GQA(*(_t(mx[w][i], cfg, device)
                  for w in ("wq", "wk", "wv", "wo")), **bias),
            Norm(_t(stack["norm2"]["scale"][i], cfg, device)),
            MLP(_t(ffn["w1"][i], cfg, device), _t(ffn["w2"][i], cfg, device),
                _t(ffn["w3"][i], cfg, device) if "w3" in ffn else None)))
    emb = params["embed"]
    return Transformer(Embed(_t(emb["embed"], cfg, device),
                             _t(emb["unembed"], cfg, device)),
                       layers,
                       Norm(_t(params["final_norm"]["scale"], cfg, device)))

"""GQA attention (llama-class): parameters, full-sequence forward and
single-step decode against a pre-allocated KV cache.

Counterpart of ``repro.models.attention`` (GQA only). The attention math
runs through ``repro_torch.kernels.ops.attention`` — the NTX MAX+MAC
streaming reduction (the CUDA flash kernel on the card).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.kernels import ops
from .common import ArchConfig, _param, apply_rope, dense_init


class GQA(nn.Module):
    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_param(wq), _param(wk),
                                              _param(wv), _param(wo))
        self.bq = _param(bq) if bq is not None else None
        self.bk = _param(bk) if bk is not None else None
        self.bv = _param(bv) if bv is not None else None


def gqa_params(cfg: ArchConfig, gen: torch.Generator) -> GQA:
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    biases = {}
    if cfg.qkv_bias:
        z = lambda n: torch.zeros(n, dtype=cfg.pdtype, device=gen.device)
        biases = {"bq": z(hq), "bk": z(hkv), "bv": z(hkv)}
    return GQA(dense_init((d, hq), gen, 0, cfg.pdtype),
               dense_init((d, hkv), gen, 0, cfg.pdtype),
               dense_init((d, hkv), gen, 0, cfg.pdtype),
               dense_init((hq, d), gen, 0, cfg.pdtype), **biases)


def _qkv(cfg: ArchConfig, p: GQA, x: torch.Tensor):
    dt = cfg.cdtype
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def _rope_qk(cfg: ArchConfig, q, k, pos):
    if pos is not None:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k


def gqa_forward(cfg: ArchConfig, p: GQA, x: torch.Tensor, pos,
                causal: bool = True):
    """Self-attention over a full sequence. Returns (out, (k, v)) with
    k/v in (b, hkv, s, hd) layout, so prefill can populate a cache."""
    dt = cfg.cdtype
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, pos)
    o = ops.attention(q, k, v, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return o @ p.wo.to(dt), (k, v)


def gqa_init_cache(cfg: ArchConfig, batch: int, seq: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_kv_heads, seq, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg: ArchConfig, p: GQA, x: torch.Tensor, pos,
               cache: Dict[str, torch.Tensor], fill: int):
    """x: (b, s_new, d); cache k/v (b, hkv, S, hd); fill = current length.

    Unlike the reference, which returns an updated copy, the new keys and
    values are written into ``cache`` in place at ``fill``; the cache is
    also returned."""
    dt = cfg.cdtype
    b, s, _ = x.shape
    q, k_new, v_new = _qkv(cfg, p, x)
    q, k_new = _rope_qk(cfg, q, k_new, pos)
    cache["k"][:, :, fill:fill + s] = k_new.to(cache["k"].dtype)
    cache["v"][:, :, fill:fill + s] = v_new.to(cache["v"].dtype)
    o = ops.attention(q, cache["k"].to(dt), cache["v"].to(dt), causal=True,
                      kv_len=fill + s)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return o @ p.wo.to(dt), cache

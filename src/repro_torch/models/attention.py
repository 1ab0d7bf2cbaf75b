"""Attention blocks: GQA (llama-class; M-RoPE for the VLM, and
cross-attention on given keys and values for the encoder-decoder) and
MLA (deepseek-v2 class): parameters, full-sequence forward and decode
against a pre-allocated cache.

Counterpart of ``repro.models.attention``. The attention math runs
through ``repro_torch.kernels.ops.attention`` — the NTX MAX+MAC streaming
reduction (the CUDA flash kernel on the card; MLA's q/k of nope + rope
dims against v of ``v_head_dim`` takes its (192, 128) route). MLA's
absorbed decode form is einsums and a softmax in the reference and stays
plain PyTorch here. On a mesh's model axis both split their heads
Megatron-style (:func:`gqa_forward`, :func:`_mla_qkv`); MLA's shared
latent is computed whole on every rank.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.kernels import ops
from .common import (ArchConfig, _param, apply_mrope, apply_rope,
                     dense_init, rank_heads, rmsnorm, take_heads, tp_copy,
                     tp_enter, tp_exit, tp_whole)


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
    """RoPE at ``pos`` (b, s), M-RoPE at ``pos`` (3, b, s) when
    ``cfg.mrope``; none when ``pos`` is None (the encoder-decoder)."""
    if cfg.mrope:
        q = apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos, cfg.rope_theta, cfg.mrope_sections)
    elif pos is not None:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k


def gqa_heads(cfg: ArchConfig):
    """(q_lo, q_hi, k_lo, k_hi): the q heads this rank computes
    (:func:`rank_heads`) and the kv heads those q heads read."""
    g = cfg.n_heads // cfg.n_kv_heads
    q_lo, q_hi = rank_heads(cfg.n_heads)
    return q_lo, q_hi, q_lo // g, (q_hi - 1) // g + 1


def gqa_forward(cfg: ArchConfig, p: GQA, x: torch.Tensor, pos,
                causal: bool = True, kv=None):
    """Self- or cross-attention over a full sequence. ``kv``: (k, v)
    already in (b, hkv, skv, hd) layout for cross-attention (the
    encoder-decoder's decoder attending to the encoder; only the query is
    projected, with ``wq`` and ``bq``, and nothing rotated); otherwise
    computed from x. Returns (out, (k, v)) with k/v in (b, hkv, s, hd)
    layout, so prefill can populate a cache.

    On a mesh's model axis (:class:`TensorParallel`) the layer is
    Megatron's: the rank computes its q heads and the kv heads those read
    (:func:`gqa_heads`; a given ``kv`` holds those kv heads);
    ``wq`` / ``wk`` / ``wv`` (and the biases) are column-parallel and
    ``wo`` row-parallel by heads. Where the rank's stored block of a
    weight is not the heads it computes (kv heads that do not divide over
    the model axis: half a head a rank), it gathers the weight and cuts
    its heads (:func:`take_heads`). The output is the partial
    ``o @ wo`` summed over ``model`` (:func:`tp_exit`); k and v are the
    rank's kv heads. Without a model axis the range is every head."""
    dt, hd = cfg.cdtype, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    q_lo, q_hi, k_lo, k_hi = gqa_heads(cfg)
    nq, nk = q_hi - q_lo, k_hi - k_lo

    def cols(w, heads, lo, hi):
        return take_heads(w, -1, heads, hd, lo, hi, dt)

    h = tp_enter(x)
    b, s, _ = h.shape
    q = h @ cols(p.wq, hq, q_lo, q_hi)
    if kv is None:
        k = h @ cols(p.wk, hkv, k_lo, k_hi)
        v = h @ cols(p.wv, hkv, k_lo, k_hi)
    if cfg.qkv_bias:
        q = q + cols(p.bq, hq, q_lo, q_hi)
        if kv is None:
            k = k + cols(p.bk, hkv, k_lo, k_hi)
            v = v + cols(p.bv, hkv, k_lo, k_hi)
    q = q.reshape(b, s, nq, hd).transpose(1, 2)
    if kv is None:
        k = k.reshape(b, s, nk, hd).transpose(1, 2)
        v = v.reshape(b, s, nk, hd).transpose(1, 2)
        q, k = _rope_qk(cfg, q, k, pos)
    else:
        k, v = kv
    kv_of_q = [j // g - k_lo for j in range(q_lo, q_hi)]
    ka, va = k, v
    if nq % nk or kv_of_q != [j // (nq // nk) for j in range(nq)]:
        # the local q heads do not fall into equal groups: one kv head
        # a q head
        idx = torch.tensor(kv_of_q, device=k.device)
        ka, va = k[:, idx], v[:, idx]
    o = ops.attention(q, ka, va, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, nq * hd)
    return tp_exit(o @ take_heads(p.wo, 0, hq, hd, q_lo, q_hi, dt)), (k, v)


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


# ----------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2)
# ----------------------------------------------------------------------
class MLA(nn.Module):
    """wq (d, h (dn + dr)); the joint KV compression and shared rope key
    wdkv (d, r + dr); the up-projections wuk (r, h dn) and wuv (r, h dv);
    wo (h dv, d); the latent's norm kv_norm (r,)."""

    NAMES = ("wq", "wdkv", "wuk", "wuv", "wo", "kv_norm")

    def __init__(self, wq, wdkv, wuk, wuv, wo, kv_norm):
        super().__init__()
        self.wq, self.wdkv, self.wuk, self.wuv, self.wo = (
            _param(wq), _param(wdkv), _param(wuk), _param(wuv), _param(wo))
        self.kv_norm = _param(kv_norm)


def mla_params(cfg: ArchConfig, gen: torch.Generator) -> MLA:
    d, r, h = cfg.d_model, cfg.kv_lora_rank, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    init = lambda shape: dense_init(shape, gen, 0, cfg.pdtype)
    return MLA(init((d, h * (dn + dr))), init((d, r + dr)), init((r, h * dn)),
               init((r, h * dv)), init((h * dv, d)),
               torch.ones(r, dtype=cfg.pdtype, device=gen.device))


def _mla_qkv(cfg: ArchConfig, p: MLA, x: torch.Tensor, pos):
    """(q_nope (b, h, s, dn), q_rope (b, h, s, dr), c_kv (b, s, r) normed,
    k_rope (b, 1, s, dr)), the rope parts rotated at ``pos``.

    On a model axis ``h`` is this rank's heads: ``wq`` is column-parallel
    by heads; ``wdkv`` and ``kv_norm`` are replicated, and every rank
    computes the latent ``c_kv`` and ``k_rope`` whole (:func:`tp_whole`)
    and hands them to its heads through :func:`tp_copy`."""
    dt = cfg.cdtype
    r = cfg.kv_lora_rank
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    lo, hi = rank_heads(cfg.n_heads)
    x = tp_whole(x)
    b, s, _ = x.shape
    wq = take_heads(p.wq, 1, cfg.n_heads, dn + dr, lo, hi, dt)
    q = (tp_copy(x) @ wq).reshape(b, s, hi - lo, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv = x @ p.wdkv.to(dt)                                # (b, s, r + dr)
    c_kv, k_rope = ckv[..., :r], ckv[..., r:]
    c_kv = rmsnorm(c_kv, p.kv_norm)
    k_rope = apply_rope(k_rope[:, None], pos, cfg.rope_theta)  # (b,1,s,dr)
    return q_nope, q_rope, tp_copy(c_kv), tp_copy(k_rope)


def _mla_attend(cfg: ArchConfig, p: MLA, q_nope, q_rope, c_kv, k_rope,
                kv_len=None):
    """Expanded-form MLA attention: the latent up-projected to per-head
    keys (nope + the broadcast rope key) and values, then
    ``ops.attention`` at scale (dn + dr)^-0.5. On a model axis the rank's
    heads: ``wuk`` and ``wuv`` column-parallel, ``wo`` row-parallel, the
    partial output summed over ``model`` (:func:`tp_exit`)."""
    dt = cfg.cdtype
    b, s = q_nope.shape[0], q_nope.shape[2]
    skv = c_kv.shape[1]
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    lo, hi = rank_heads(cfg.n_heads)
    h = hi - lo
    cols = lambda w, size: take_heads(w, 1, cfg.n_heads, size, lo, hi, dt)
    k_nope = (c_kv @ cols(p.wuk, dn)).reshape(b, skv, h, dn).transpose(1, 2)
    v = (c_kv @ cols(p.wuv, dv)).reshape(b, skv, h, dv).transpose(1, 2)
    k_rope_b = k_rope.expand(b, h, skv, dr)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_b], -1)
    o = ops.attention(q, k, v, causal=True, scale=(dn + dr) ** -0.5,
                      kv_len=kv_len)
    o = o.transpose(1, 2).reshape(b, s, h * dv)
    return tp_exit(o @ take_heads(p.wo, 0, cfg.n_heads, dv, lo, hi, dt))


def mla_forward(cfg: ArchConfig, p: MLA, x: torch.Tensor, pos,
                causal: bool = True):
    """Returns (out, (c_kv, k_rope)), the latent cache entries of x."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, pos)
    return _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope), (c_kv, k_rope)


def mla_init_cache(cfg: ArchConfig, batch: int, seq: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    return {"c_kv": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, 1, seq, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(cfg: ArchConfig, p: MLA, x: torch.Tensor, pos,
               cache: Dict[str, torch.Tensor], fill: int,
               absorbed: bool = False):
    """x: (b, s_new, d); cache c_kv (b, S, r) and k_rope (b, 1, S, dr),
    written in place at ``fill`` (the reference returns an updated copy)
    and returned. ``absorbed``: attend in the latent space
    (:func:`_mla_attend_absorbed`) instead of expanding the cache."""
    dt = cfg.cdtype
    s = x.shape[1]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(cfg, p, x, pos)
    cache["c_kv"][:, fill:fill + s] = c_kv_new.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :, fill:fill + s] = k_rope_new.to(
        cache["k_rope"].dtype)
    attend = _mla_attend_absorbed if absorbed else _mla_attend
    out = attend(cfg, p, q_nope, q_rope, cache["c_kv"].to(dt),
                 cache["k_rope"].to(dt), kv_len=fill + s)
    return out, cache


def _mla_attend_absorbed(cfg: ArchConfig, p: MLA, q_nope, q_rope, c_kv,
                         k_rope, kv_len):
    """Absorbed-matmul MLA decode: W_uk folded into the query and W_uv into
    the output, so attention runs in the r-dim latent space over the
    latent cache and the shared rope key (einsums and a softmax, as in
    the reference)."""
    dt = cfg.cdtype
    b, h, s, dn = q_nope.shape
    r, dr, dv = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    skv = c_kv.shape[1]
    wuk = p.wuk.to(dt).reshape(r, h, dn)
    q_lat = torch.einsum("bhsd,rhd->bhsr", q_nope, wuk)
    scale = (dn + dr) ** -0.5
    logits = (torch.einsum("bhsr,bkr->bhsk", q_lat, c_kv)
              + torch.einsum("bhsd,bkd->bhsk", q_rope, k_rope[:, 0])) * scale
    kpos = torch.arange(skv, device=c_kv.device)[None, None, None, :]
    qpos = kv_len - s + torch.arange(s, device=c_kv.device)[None, None, :,
                                                             None]
    logits = torch.where(kpos <= qpos, logits.float(),
                         torch.full((), float("-inf"), device=c_kv.device))
    pr = torch.softmax(logits, -1).to(dt)
    o_lat = torch.einsum("bhsk,bkr->bhsr", pr, c_kv)
    wuv = p.wuv.to(dt).reshape(r, h, dv)
    o = torch.einsum("bhsr,rhd->bhsd", o_lat, wuv)
    o = o.transpose(1, 2).reshape(b, s, h * dv)
    return o @ p.wo.to(dt)

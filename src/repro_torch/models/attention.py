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
latent is computed whole on every rank. With ``cfg.ctx_parallel`` GQA
self-attention is context-parallel instead (:func:`_gqa_ctx`): a rank
attends its block of the queries, every head, over the keys and values
all-gathered over the sequence.

Decode on a mesh reads the layer's cache as ``cache_specs`` places it
(``models/common.py``: :func:`~.common.cache_split`): a cache split by kv
heads (``cfg.cache_shard == "heads"``) or whole is the head split as in
training; one split by the sequence (``"seq"``) has every rank attend
every head over its block of the keys (:func:`attend_block`) and merge
the partials by their log-sum-exps (:func:`~.common.merge_partials`);
MLA's latent split by its feature axes (``"latent"``) sums the partial
logits of the absorbed form over ``model``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

import torch.distributed as dist

from repro_torch.kernels import ops
from .common import (ArchConfig, _param, apply_mrope, apply_rope,
                     cache_local, cache_split, cache_take,
                     cache_write, ctx_constrain_out, ctx_constrain_q,
                     ctx_parallel_on, ctx_replicate_kv, dense_init,
                     gather_part, merge_partials, rank_heads, rank_ranges,
                     rmsnorm, shard_range, take_heads, tp_copy, tp_enter,
                     tp_exit, tp_state, tp_whole, whole_weight)

#: the ROADMAP item a GQA cache split by head_dim waits for
GQA_LATENT_ITEM = ("ROADMAP queue 1 item 14b: a GQA decode cache split by "
                   "head_dim (cache_shard='latent')")


def gqa_cache_by_head_dim(cfg: ArchConfig, nm: int) -> bool:
    """True where ``cache_specs`` splits a GQA cache's head_dim over a
    model axis of ``nm`` ranks (``cache_shard="latent"`` and head_dim
    dividing), which no flash call can contract: the mesh's decode step
    refuses it (``runtime.serve.check_mesh_serve``), naming
    :data:`GQA_LATENT_ITEM`."""
    return (not cfg.mla and cfg.cache_shard == "latent" and nm > 1
            and cfg.hd % nm == 0)


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


def gqa_head_ranges(cfg: ArchConfig) -> list:
    """Every model rank's [lo, hi) of the kv heads (:func:`gqa_heads`), in
    rank order (they overlap where ranks share a kv head)."""
    g = cfg.n_heads // cfg.n_kv_heads
    return [(lo // g, (hi - 1) // g + 1) for lo, hi in
            rank_ranges(cfg.n_heads)]


def _gqa_proj(cfg: ArchConfig, p: GQA, h: torch.Tensor, pos, kv=None):
    """This rank's q heads and the kv heads they read (:func:`gqa_heads`)
    of ``h`` (b, s, d), in (b, heads, s, hd) layout: ``wq`` / ``wk`` /
    ``wv`` (and the biases) column-parallel, rotated at ``pos``; a given
    ``kv`` (cross-attention) is taken as it is."""
    dt, hd = cfg.cdtype, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q_lo, q_hi, k_lo, k_hi = gqa_heads(cfg)
    nq, nk = q_hi - q_lo, k_hi - k_lo

    def cols(w, heads, lo, hi):
        return take_heads(w, -1, heads, hd, lo, hi, dt)

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
    return q, k, v


def _kv_for_q(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor):
    """The rank's kv heads as its q heads read them: as they are where the
    q heads fall into equal groups, else one kv head a q head."""
    if tp_state() is None:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    q_lo, q_hi, k_lo, k_hi = gqa_heads(cfg)
    nq, nk = q_hi - q_lo, k_hi - k_lo
    kv_of_q = [j // g - k_lo for j in range(q_lo, q_hi)]
    if nq % nk or kv_of_q != [j // (nq // nk) for j in range(nq)]:
        idx = torch.tensor(kv_of_q, device=k.device)
        return k[:, idx], v[:, idx]
    return k, v


def _gqa_out(cfg: ArchConfig, p: GQA, o: torch.Tensor) -> torch.Tensor:
    """This rank's q heads' output (b, nq, s, hd) through its rows of
    ``wo`` (row-parallel), the partial sums over ``model``
    (:func:`tp_exit`)."""
    b, nq, s, hd = o.shape
    q_lo, q_hi = rank_heads(cfg.n_heads)
    o = o.transpose(1, 2).reshape(b, s, nq * hd)
    return tp_exit(o @ take_heads(p.wo, 0, cfg.n_heads, hd, q_lo, q_hi,
                                  cfg.cdtype))


def _gqa_ctx(cfg: ArchConfig, p: GQA, x: torch.Tensor, pos, causal: bool):
    """Context-parallel self-attention (the reference's
    ``ctx_constrain_q`` / ``ctx_replicate_kv``): rank r computes q, k and
    v for every head from its block of the sequence, [r s/nm, (r+1)
    s/nm) (:func:`ctx_constrain_q`), all-gathers k and v over the
    sequence (:func:`ctx_replicate_kv`), attends its queries over the
    keys [0, (r+1) s/nm) (causal: the flash kernels' bottom-right
    alignment puts query i at its absolute position) or over all of them,
    and multiplies its block of o by all of ``wo``; the block goes back
    to the residual's layout (:func:`ctx_constrain_out`). No
    ``tp_enter`` / ``tp_exit``: the weights are whole on every rank,
    stored replicated or gathered each layer (:func:`whole_weight`).
    Returns (out, (k, v)) with every head's k and v of the whole
    sequence."""
    dt, hd = cfg.cdtype, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    tp = tp_state()
    xb = ctx_constrain_q(x)
    b, sl, _ = xb.shape
    lo = tp.rank * sl
    if pos is not None:
        pos = pos[..., lo:lo + sl]
    q = xb @ whole_weight(p.wq, -1, hq * hd, dt)
    k = xb @ whole_weight(p.wk, -1, hkv * hd, dt)
    v = xb @ whole_weight(p.wv, -1, hkv * hd, dt)
    if cfg.qkv_bias:
        q = q + whole_weight(p.bq, 0, hq * hd, dt)
        k = k + whole_weight(p.bk, 0, hkv * hd, dt)
        v = v + whole_weight(p.bv, 0, hkv * hd, dt)
    q = q.reshape(b, sl, hq, hd).transpose(1, 2)
    k = k.reshape(b, sl, hkv, hd).transpose(1, 2)
    v = v.reshape(b, sl, hkv, hd).transpose(1, 2)
    q, k = _rope_qk(cfg, q, k, pos)
    k, v = ctx_replicate_kv(k), ctx_replicate_kv(v)
    hi = lo + sl if causal else k.shape[2]
    o = ops.attention(q, k[:, :, :hi], v[:, :, :hi], causal=causal)
    o = o.transpose(1, 2).reshape(b, sl, hq * hd)
    out = o @ whole_weight(p.wo, 0, hq * hd, dt)
    return ctx_constrain_out(out), (k, v)


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
    rank's kv heads. Without a model axis the range is every head.

    With ``cfg.ctx_parallel``, for self-attention over a sequence that
    divides over the model axis, the layer is context-parallel instead
    (:func:`_gqa_ctx`; k and v then hold every head). Weights stored
    replicated (the context-parallel layout) are cut to the rank's heads
    where the layer falls back to the head split."""
    if kv is None and ctx_parallel_on(cfg, x):
        return _gqa_ctx(cfg, p, x, pos, causal)
    q, k, v = _gqa_proj(cfg, p, tp_enter(x), pos, kv)
    o = ops.attention(q, *_kv_for_q(cfg, k, v), causal=causal)
    return _gqa_out(cfg, p, o), (k, v)


def gqa_init_cache(cfg: ArchConfig, batch: int, seq: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_kv_heads, seq, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_block(q, k, v, lo: int, hi: int, q_pos: int, causal: bool = True,
                 scale=None):
    """Partial attention of queries at absolute positions ``q_pos + i``
    (q (b, hq, sq, d)) over one block of the keys, positions [lo, hi)
    (k / v (b, hkv, hi - lo, ·)): ``(o, lse)`` for
    :func:`~.common.merge_partials`. Causal: query i sees the block's
    keys up to its own position, so the queries fall into three groups,
    each contiguous: those before the block (no key: o 0, lse -inf, no
    launch: a kernel takes no empty sequence), those inside it (a causal
    call over keys up to the last of them, which the kernels' bottom-right
    alignment puts right) and those past it (every key of the block, not
    causal). Not causal: every key of the block."""
    b, hq, sq, _ = q.shape
    dv = v.shape[-1]
    n = hi - lo
    if not causal:
        return ops.attention(q, k, v, causal=False, scale=scale, kv_len=n,
                             return_lse=True)
    i_in = min(max(lo - q_pos, 0), sq)       # first query inside
    i_past = min(max(hi - q_pos, 0), sq)     # first query past the block
    parts = []
    if i_past > i_in:
        parts.append(ops.attention(q[:, :, i_in:i_past], k, v, causal=True,
                                   scale=scale, kv_len=q_pos + i_past - lo,
                                   return_lse=True))
    if sq > i_past:
        parts.append(ops.attention(q[:, :, i_past:], k, v, causal=False,
                                   scale=scale, kv_len=n, return_lse=True))
    if i_in == 0 and len(parts) == 1:
        return parts[0]
    o = q.new_zeros((b, hq, sq, dv))
    lse = torch.full((b, hq, sq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    at = i_in
    for po, pl in parts:
        o[:, :, at:at + po.shape[2]] = po
        lse[:, :, at:at + po.shape[2]] = pl
        at += po.shape[2]
    return o, lse


def gqa_decode(cfg: ArchConfig, p: GQA, x: torch.Tensor, pos,
               cache: Dict[str, torch.Tensor], fill: int):
    """x: (b, s_new, d); cache k/v (b, hkv, S, hd); fill = current length.

    Unlike the reference, which returns an updated copy, the new keys and
    values are written into ``cache`` in place at ``fill``; the cache is
    also returned.

    On a mesh the rank computes its q heads and their kv heads, as in
    :func:`gqa_forward`, and reads the cache as ``cache_specs`` placed it
    (:func:`~.common.cache_split`): split by kv heads, or whole (every
    rank writes the same bytes: the new entries gathered over ``model``),
    it attends its q heads; split by the sequence, it gathers every
    head's q, k and v of the new tokens (small: (b, h, s_new, hd)), the
    rank owning position ``fill + i`` writes that slot, every rank
    attends every head over its block (:func:`attend_block`) and the
    partials are merged over ``model``; then ``o @ wo`` is row-parallel
    over the rank's heads (:func:`tp_exit`). A cache split by head_dim
    (:func:`gqa_cache_by_head_dim`) is refused before the step runs."""
    dt = cfg.cdtype
    s = x.shape[1]
    q, k_new, v_new = _gqa_proj(cfg, p, x, pos)
    split = cache_split(cache["k"])
    kv_part = (1, gqa_head_ranges(cfg))
    if split is None or split[0] == 1:
        _, _, k_lo, k_hi = gqa_heads(cfg)
        for name, new in (("k", k_new), ("v", v_new)):
            cache_write(cache[name], new, 2, fill, part=kv_part)
        k = cache_take(cache["k"], 1, k_lo, k_hi).to(dt)
        v = cache_take(cache["v"], 1, k_lo, k_hi).to(dt)
        o = ops.attention(q, *_kv_for_q(cfg, k, v), causal=True,
                          kv_len=fill + s)
        return _gqa_out(cfg, p, o), cache
    assert split[0] == 2, GQA_LATENT_ITEM        # check_mesh_serve's
    _, lo, hi = split
    qa = gather_part(q, 1, rank_ranges(cfg.n_heads))
    for name, new in (("k", k_new), ("v", v_new)):
        cache_write(cache[name], gather_part(new, 1, kv_part[1]), 2, fill)
    o, lse = attend_block(qa, cache_local(cache["k"]).to(dt),
                          cache_local(cache["v"]).to(dt), lo, hi, fill)
    q_lo, q_hi = rank_heads(cfg.n_heads)
    o = merge_partials(o, lse)[:, q_lo:q_hi]
    return _gqa_out(cfg, p, o), cache


def cross_decode(cfg: ArchConfig, p: GQA, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]):
    """The encoder-decoder's cross-attention in decode, on the cached
    encoder keys and values ``ck`` / ``cv``: the rank's q heads over its
    kv heads where the cache is split by heads or whole; split by the
    sequence (``cache_specs`` where the frames divide over ``model``),
    every head over the rank's block of the frames, merged over
    ``model``."""
    dt = cfg.cdtype
    split = cache_split(cache["ck"])
    if split is None or split[0] == 1:
        _, _, k_lo, k_hi = gqa_heads(cfg)
        kv = (cache_take(cache["ck"], 1, k_lo, k_hi).to(dt),
              cache_take(cache["cv"], 1, k_lo, k_hi).to(dt))
        return gqa_forward(cfg, p, x, None, causal=False, kv=kv)[0]
    assert split[0] == 2, GQA_LATENT_ITEM        # check_mesh_serve's
    _, lo, hi = split
    q, _, _ = _gqa_proj(cfg, p, x, None, kv=(None, None))
    qa = gather_part(q, 1, rank_ranges(cfg.n_heads))
    o, lse = attend_block(qa, cache_local(cache["ck"]).to(dt),
                          cache_local(cache["cv"]).to(dt), lo, hi, 0,
                          causal=False)
    q_lo, q_hi = rank_heads(cfg.n_heads)
    return _gqa_out(cfg, p, merge_partials(o, lse)[:, q_lo:q_hi])


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
    (:func:`_mla_absorbed_block`) instead of expanding the cache.

    On a mesh the new latent entries are whole on every rank and each
    rank writes its block of them. A cache split by the sequence
    (``"seq"``) has every rank attend every head over its block of the
    positions (expanded: the block's keys and values up-projected for
    every head, ``wuk`` / ``wuv`` gathered; absorbed: in the latent
    space) and merge the partials over ``model``. With ``c_kv`` split by
    its rank dimension (``"latent"``) the absorbed form sums its partial
    logits over ``model`` (:func:`_mla_absorbed_latent`); the expanded
    form gathers the latent whole (its up-projection contracts r for
    every head, which a sum over ``model`` would move as (b, S, h dn)).
    The output is the rank's heads through ``wo`` (row-parallel)."""
    dt = cfg.cdtype
    s = x.shape[1]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(cfg, p, x, pos)
    cache_write(cache["c_kv"], c_kv_new, 1, fill)
    cache_write(cache["k_rope"], k_rope_new, 2, fill)
    cs = cache_split(cache["c_kv"])
    ks = cache_split(cache["k_rope"])
    if cs is not None and cs[0] == 1 and ks is not None and ks[0] == 2:
        _, lo, hi = cs
        c_kv = cache_local(cache["c_kv"]).to(dt)
        k_rope = cache_local(cache["k_rope"]).to(dt)
        heads = rank_ranges(cfg.n_heads)
        if absorbed:
            o, lse = _mla_absorbed_block(
                cfg, gather_part(_latent_q(cfg, p, q_nope), 1, heads),
                gather_part(q_rope, 1, heads), c_kv, k_rope, lo, fill)
        else:
            o, lse = _mla_expanded_block(cfg, p, q_nope, q_rope, c_kv,
                                         k_rope, lo, hi, fill)
        q_lo, q_hi = rank_heads(cfg.n_heads)
        o = merge_partials(o, lse)[:, q_lo:q_hi]
        if absorbed:
            o = _latent_out(cfg, p, o)
        return _mla_out(cfg, p, o), cache
    if absorbed and cs is not None and cs[0] == 2:
        return _mla_absorbed_latent(cfg, p, q_nope, q_rope, cache,
                                    fill), cache
    skv = cache["c_kv"].shape[1]
    c_kv = cache_take(cache["c_kv"], 1, 0, skv).to(dt)
    k_rope = cache_take(cache["k_rope"], 2, 0, skv).to(dt)
    if not absorbed:
        return _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope,
                           kv_len=fill + s), cache
    o_lat, _ = _mla_absorbed_block(cfg, _latent_q(cfg, p, q_nope), q_rope,
                                   c_kv, k_rope, 0, fill)
    return _mla_out(cfg, p, _latent_out(cfg, p, o_lat)), cache


def _mla_out(cfg: ArchConfig, p: MLA, o: torch.Tensor) -> torch.Tensor:
    """The rank's heads' output (b, h, s, dv) through its rows of ``wo``,
    summed over ``model`` (:func:`tp_exit`)."""
    b, h, s, dv = o.shape
    lo, hi = rank_heads(cfg.n_heads)
    o = o.transpose(1, 2).reshape(b, s, h * dv)
    return tp_exit(o @ take_heads(p.wo, 0, cfg.n_heads, dv, lo, hi,
                                  cfg.cdtype))


def _up(cfg: ArchConfig, w: torch.Tensor, size: int, lo: int, hi: int):
    """Heads [lo, hi) of an up-projection (r, h size) as (r, hi - lo,
    size)."""
    r = cfg.kv_lora_rank
    return take_heads(w, 1, cfg.n_heads, size, lo, hi, cfg.cdtype).reshape(
        r, hi - lo, size)


def _latent_q(cfg: ArchConfig, p: MLA, q_nope: torch.Tensor):
    """The rank's heads' queries folded into the latent space, q_nope
    W_uk: (b, h, s, r)."""
    lo, hi = rank_heads(cfg.n_heads)
    return torch.einsum("bhsd,rhd->bhsr", q_nope,
                        _up(cfg, p.wuk, cfg.nope_head_dim, lo, hi))


def _latent_out(cfg: ArchConfig, p: MLA, o_lat: torch.Tensor):
    """The rank's heads' latent outputs (b, h, s, r) unfolded by W_uv."""
    lo, hi = rank_heads(cfg.n_heads)
    return torch.einsum("bhsr,rhd->bhsd", o_lat,
                        _up(cfg, p.wuv, cfg.v_head_dim, lo, hi))


def _mla_expanded_block(cfg: ArchConfig, p: MLA, q_nope, q_rope, c_kv,
                        k_rope, lo: int, hi: int, fill: int):
    """Every head's expanded attention over this rank's block [lo, hi) of
    the latent cache: (o (b, h, s, dv), lse)."""
    b, skv = c_kv.shape[0], c_kv.shape[1]
    h = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    heads = rank_ranges(h)
    q = gather_part(torch.cat([q_nope, q_rope], -1), 1, heads)
    k_nope = torch.einsum("bkr,rhd->bhkd", c_kv, _up(cfg, p.wuk, dn, 0, h))
    v = torch.einsum("bkr,rhd->bhkd", c_kv, _up(cfg, p.wuv, dv, 0, h))
    k = torch.cat([k_nope, k_rope.expand(b, h, skv, dr)], -1)
    return attend_block(q, k, v, lo, hi, fill, scale=(dn + dr) ** -0.5)


def _latent_softmax(logits: torch.Tensor, c_kv: torch.Tensor, lo: int,
                    q_pos: int):
    """The absorbed form's attention from its scaled logits (b, h, s, skv)
    of queries at positions ``q_pos + i`` over latent entries ``c_kv``
    (b, skv, ·) at positions [lo, lo + skv), causal: the fp32 softmax in
    c_kv's dtype times c_kv, as the reference's, and each row's fp32
    log-sum-exp; a row without a key in the block gives o 0, lse -inf."""
    s, skv = logits.shape[-2:]
    kpos = lo + torch.arange(skv, device=c_kv.device)
    qpos = q_pos + torch.arange(s, device=c_kv.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None], logits.float(),
                         float("-inf"))
    pr = torch.softmax(logits, -1).nan_to_num(0.0).to(c_kv.dtype)
    return (torch.einsum("bhsk,bkr->bhsr", pr, c_kv),
            torch.logsumexp(logits, -1))


def _mla_absorbed_block(cfg: ArchConfig, q_lat, q_rope, c_kv, k_rope,
                        lo: int, fill: int):
    """Absorbed-matmul MLA attention (the reference's
    ``_mla_attend_absorbed``): W_uk folded into the query (``q_lat``, b,
    h, s, r: :func:`_latent_q`) and W_uv into the output
    (:func:`_latent_out`), so attention runs in the r-dim latent space
    over the latent cache and the shared rope key (einsums and a softmax,
    plain PyTorch as in the reference), here over its entries at
    positions [lo, lo + c_kv.shape[1]) for queries at ``fill + i``:
    (o_lat (b, h, s, r), lse). The whole cache is the block at 0."""
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    logits = (torch.einsum("bhsr,bkr->bhsk", q_lat, c_kv)
              + torch.einsum("bhsd,bkd->bhsk", q_rope, k_rope[:, 0])
              ) * (dn + dr) ** -0.5
    return _latent_softmax(logits, c_kv, lo, fill)


def _mla_absorbed_latent(cfg: ArchConfig, p: MLA, q_nope, q_rope,
                         cache: Dict[str, torch.Tensor], fill: int):
    """The absorbed form over a latent cache whose ``c_kv`` is split by its
    rank dimension r (a contracted axis) over ``model``: every head's
    partial logits over the rank's block of r (and of the rope key's dr
    where ``k_rope`` splits it too; a whole rope key's term is added by
    model rank 0 alone) summed over ``model``; the softmax on every rank;
    the rank's block of the latent output gathered over r; its heads
    through W_uv and ``wo``."""
    dt, tp = cfg.cdtype, tp_state()
    dn, dr, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    heads = rank_ranges(cfg.n_heads)
    _, r_lo, r_hi = cache_split(cache["c_kv"])
    c_kv = cache_local(cache["c_kv"]).to(dt)
    q_lat = gather_part(_latent_q(cfg, p, q_nope), 1, heads)
    q_rope = gather_part(q_rope, 1, heads)
    skv = c_kv.shape[1]
    logits = torch.einsum("bhsr,bkr->bhsk", q_lat[..., r_lo:r_hi],
                          c_kv).float()
    ks = cache_split(cache["k_rope"])
    if ks is not None and ks[0] == 3:
        k_rope = cache_local(cache["k_rope"]).to(dt)
        logits = logits + torch.einsum("bhsd,bkd->bhsk",
                                       q_rope[..., ks[1]:ks[2]],
                                       k_rope[:, 0]).float()
    elif tp.rank == 0:
        k_rope = cache_take(cache["k_rope"], 2, 0, skv).to(dt)
        logits = logits + torch.einsum("bhsd,bkd->bhsk", q_rope,
                                       k_rope[:, 0]).float()
    dist.all_reduce(logits, group=tp.group)
    o_lat, _ = _latent_softmax(logits * (dn + dr) ** -0.5, c_kv, 0, fill)
    o_lat = gather_part(o_lat, 3, [shard_range(r, tp.nm, i)
                                   for i in range(tp.nm)])
    q_lo, q_hi = rank_heads(cfg.n_heads)
    return _mla_out(cfg, p, _latent_out(cfg, p, o_lat[:, q_lo:q_hi]))

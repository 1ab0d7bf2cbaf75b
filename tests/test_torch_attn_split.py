"""Decode over a GQA cache split by head_dim (``cache_shard="latent"``) on
one process: the two kernels of ``csrc/ntx_attn_split.cu`` through their
plain versions, the wrappers' CPU and meta routes, and the softmax-PV
kernel's plan, on the CPU.

A model axis of nm ranks holds blocks of db = hd / nm of every kv head's
head_dim. Each block's partial logits (``ops.attention_split_logits``)
summed over the blocks, then each block's softmax-PV
(``ops.attention_split_softmax_pv``) and the blocks side by side, must be
the reference's single-device ``ops.attention`` (its ``ref`` backend)
over the whole heads within 1e-5 in fp32: causal decode steps of one and
two queries at a fill below the cache's size, GQA groups of 1, 4 and 6,
and a non-causal cross-attention over every frame. The kernel's tiles and
key splits are emulated in plain PyTorch (each split's base-2 max, sum
and accumulator, merged in split order) against the plain version, and the plan's constants are held to the kernel source.
The mesh steps that call these wrappers are held in
``tests/test_torch_mesh_serve.py`` (the ``*_latent`` cases); the card
runs the kernels against these plain versions (``chip_smoke.py`` phase 21
and ``tests/test_torch_gpu.py``).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models.common import shard_range

TOL = 1e-5

#: (b, hq, hkv, s, S, kv_len, hd, nm, causal)
CASES = {
    "g1_causal": (2, 4, 4, 1, 64, 40, 32, 4, True),
    "g4_full_cache": (2, 8, 2, 1, 64, 64, 16, 4, True),
    "g4_two_queries": (2, 8, 2, 2, 64, 33, 16, 2, True),
    "g6_two_queries_8_ranks": (1, 12, 2, 2, 96, 50, 32, 8, True),
    "g4_long_cache_16_ranks": (1, 8, 2, 1, 1500, 1200, 128, 16, True),
    "cross_not_causal": (2, 4, 4, 1, 100, 100, 32, 4, False),
}


def _inputs(b, hq, hkv, s, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return mk(b, hq, s, hd), mk(b, hkv, S, hd), mk(b, hkv, S, hd)


def _split_attention(q, k, v, kv_len, nm, causal):
    """Every block's partial logits summed, every block's softmax-PV over
    the sum, the blocks side by side: what the model ranks compute."""
    hd, s = q.shape[-1], q.shape[2]
    blocks = [shard_range(hd, nm, r) for r in range(nm)]
    logits = sum(tops.attention_split_logits(q[..., lo:hi], k[..., lo:hi],
                                             kv_len) for lo, hi in blocks)
    return torch.cat([tops.attention_split_softmax_pv(
        logits, v[..., lo:hi], kv_len - s, hd ** -0.5, causal)
        for lo, hi in blocks], -1)


@pytest.mark.parametrize("case", list(CASES))
def test_split_blocks_match_reference_attention(case):
    """The blocks' partial logits summed and their softmax-PV outputs side
    by side equal the reference's ``ops.attention`` over the whole heads
    (causal: query i at position kv_len - s + i; not causal: every key)
    within 1e-5, fp32."""
    b, hq, hkv, s, S, kv_len, hd, nm, causal = CASES[case]
    q, k, v = _inputs(b, hq, hkv, s, S, hd)
    with jops.backend("ref"):
        if causal:
            want = jops.attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  kv_len=kv_len)
        else:
            want = jops.attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False)
    got = _split_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                           kv_len, nm, causal)
    assert got.shape == (b, hq, s, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_partial_logits_sum_to_the_whole_heads():
    """The blocks' partial logits summed are the whole heads' unscaled
    logits (one block is all of head_dim); keys past kv_len are not
    computed."""
    q, k, _ = (torch.from_numpy(t) for t in _inputs(2, 8, 2, 2, 40, 16))
    whole = tops.attention_split_logits(q, k, 30)
    assert whole.shape == (2, 8, 2, 30)
    parts = sum(tops.attention_split_logits(q[..., lo:lo + 4],
                                            k[..., lo:lo + 4], 30)
                for lo in range(0, 16, 4))
    torch.testing.assert_close(parts, whole, rtol=0, atol=1e-5)
    want = torch.einsum("bhgsd,bhtd->bhgst", q.reshape(2, 2, 4, 2, 16),
                        k[:, :, :30]).reshape(2, 8, 2, 30)
    torch.testing.assert_close(whole, want, rtol=0, atol=1e-5)


def test_softmax_pv_masks_with_minus_1e30_and_keeps_v_dtype():
    """A row with no key left takes every key's value at weight 1 (the
    reference's softmax of -1e30 everywhere); o is in v's dtype, bf16
    too."""
    logits = torch.randn(1, 2, 2, 6)
    v = torch.randn(1, 1, 8, 4)
    o = tops.attention_split_softmax_pv(logits, v, -1, 1.0, causal=True)
    assert torch.allclose(o[0, :, 0], v[0, 0, :6].mean(0).expand(2, 4),
                          atol=1e-6)
    ob = tops.attention_split_softmax_pv(logits, v.bfloat16(), 3, 0.5)
    assert ob.dtype == torch.bfloat16 and ob.shape == (1, 2, 2, 4)


# ----------------------------------------------------------------------
# The kernel's tiles and splits, emulated
# ----------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _emulate_pv(logits, v, q_pos, scale, causal):
    """The softmax-PV kernel's arithmetic in plain PyTorch: each split of
    ``split_pv_plan`` takes its keys' base-2 max m, sum l and accumulator
    (a masked logit at -1e30); several splits are merged in split order
    by their (m, l, acc), l == 0 taken as 1."""
    b, hq, s, kv = logits.shape
    hkv, db = v.shape[1], v.shape[-1]
    g = hq // hkv
    plan = tfa.split_pv_plan(b, hq, hkv, s, kv, db)
    x = logits.double() * (tfa.f32(scale) * LOG2E)
    if causal:
        qpos = q_pos + torch.arange(s)[:, None]
        x = torch.where(torch.arange(kv)[None] <= qpos, x,
                        torch.full_like(x, -1e30))
    vv = v[:, :, :kv].double().repeat_interleave(g, 1)   # (b, hq, kv, db)
    parts = []
    for z in range(plan.splits):
        lo, hi = z * plan.chunk, min(kv, (z + 1) * plan.chunk)
        assert lo < hi
        m = x[..., lo:hi].amax(-1)
        p = torch.exp2(x[..., lo:hi] - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bhst,bhtd->bhsd", p, vv[:, :, lo:hi])))
    mm = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp2(p[0] - mm) for p in parts]
    l = sum(p[1] * wz for p, wz in zip(parts, w))
    acc = sum(p[2] * wz[..., None] for p, wz in zip(parts, w))
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).float(), plan.splits


@pytest.mark.parametrize("b,hq,hkv,s,kv,db", [
    (8, 32, 8, 1, 32768, 8),      # llama3-8b decode_32k, 16 model ranks
    (8, 32, 8, 2, 5000, 32),      # 4 ranks, a 2-token step
    (2, 12, 2, 2, 3000, 16),      # qwen2-vl's group of 6, 16 rows a group
    (8, 16, 16, 1, 1500, 4),      # whisper's cross-attention, one split
])
def test_emulated_splits_match_plain(b, hq, hkv, s, kv, db):
    """The kernel's tiles and key splits, emulated, equal the plain
    version within 1e-5 (in fp32 units of max|o|); a plan with several
    splits is among the cases."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((b, hq, s, kv)).astype(
        np.float32)) * 4
    v = torch.from_numpy(rng.standard_normal((b, hkv, kv + 3, db)).astype(
        np.float32))
    got, splits = _emulate_pv(logits, v, kv - s, 0.3, True)
    want = tfa.attention_split_softmax_pv_plain(logits, v, kv - s, 0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if kv == 32768:
        assert splits > 1


@pytest.mark.parametrize("b,hq,hkv,s,kv", [
    (8, 32, 8, 1, 32768), (8, 32, 8, 2, 32768), (8, 16, 16, 1, 1500),
    (1, 12, 2, 2, 50), (4, 48, 4, 3, 700), (1, 8, 8, 1, 1),
    (1, 4, 1, 1, 200000)])
def test_split_pv_plan_covers_the_keys(b, hq, hkv, s, kv):
    """The splits are whole tiles, none empty, and cover [0, kv_len); the
    row groups hold a group's g s rows; the grid's rows fit its y limit;
    each split keeps at least MIN_SPLIT_TILES chunks where there are
    several, and there are at most MAX_SPLITS (the flash merge's limit);
    the workspace holds every split's (m, l, acc) a row."""
    plan = tfa.split_pv_plan(b, hq, hkv, s, kv, 8)
    rows = hq // hkv * s
    assert plan.rb in (4, 8, 16) and (plan.row_groups - 1) * plan.rb < \
        rows <= plan.row_groups * plan.rb
    assert plan.rb == 16 or rows <= plan.rb
    assert plan.chunk % tfa.SPLIT_CHUNK == 0
    assert (plan.splits - 1) * plan.chunk < kv <= plan.splits * plan.chunk
    assert b * hkv * plan.row_groups <= 65535
    assert plan.splits <= tfa.MAX_SPLITS
    if kv == 200000:                  # one group: capped by the merge
        assert tfa.MAX_SPLITS // 2 < plan.splits < 2 * tfa.SMS
    if plan.splits > 1:
        assert plan.chunk >= tfa.MIN_SPLIT_TILES * tfa.SPLIT_CHUNK
        assert plan.workspace == plan.splits * b * hq * s * 10
        # one wave of two blocks an SM, at least one an SM at decode_32k
        assert b * hkv * plan.row_groups * plan.splits <= 2 * tfa.SMS
        if kv == 32768:
            assert b * hkv * plan.row_groups * plan.splits >= tfa.SMS
    else:
        assert plan.workspace == 0


def test_constants_match_the_kernel_source():
    """The Python side's tile, thread, row and shared-memory numbers are
    the kernel's."""
    src = (_build.CSRC / "ntx_attn_split.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([0-9 *]+);",
                         src).group(1)
        return int(np.prod([int(f) for f in expr.split("*")]))
    assert const("kThreads") == tfa.SPLIT_THREADS
    assert const("kRowsA") == tfa.SPLIT_ROWS_A
    assert const("kKeysA") == tfa.SPLIT_KEYS_A
    assert const("kChunk") == tfa.SPLIT_CHUNK
    assert const("kSmemA") == tfa.SPLIT_SMEM_A
    assert const("kMaxSplits") == tfa.MAX_SPLITS
    assert "ntx_attn_split.cu" in [p.name for p in _build.sources()]
    for fn in ("ntx_attn_split_logits", "ntx_attn_split_pv"):
        assert f"int {fn}(" in src and fn in _build._SIGNATURES


# ----------------------------------------------------------------------
# The wrappers' routes
# ----------------------------------------------------------------------
def test_meta_route_tallies_bytes_and_flops():
    """On meta tensors each wrapper checks the call, counts one call of
    its family, 2 b hq s kv_len db operations, and the bytes the kernel
    must move (q, the first kv_len keys, the logits; the logits, the
    first kv_len values, o and a split plan's workspace written and read
    again); no launch is counted."""
    b, hq, hkv, s, S, kv, db = 8, 32, 8, 1, 32768, 32000, 8
    q = torch.empty((b, hq, s, db), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, hkv, S, db), dtype=torch.bfloat16, device="meta")
    tops.reset_dry()
    tops.reset_launches()
    logits = tops.attention_split_logits(q, k, kv)
    assert logits.shape == (b, hq, s, kv) and logits.dtype == torch.float32
    o = tops.attention_split_softmax_pv(logits, k, kv - 1, db ** -0.5)
    assert o.shape == (b, hq, s, db) and o.dtype == torch.bfloat16
    dry = tops.dry()
    assert dry["calls"]["attention_split_logits"] == 1
    assert dry["calls"]["attention_split_softmax_pv"] == 1
    flops = 2 * b * hq * s * kv * db
    assert dry["flops"]["attention_split_logits"] == flops
    assert dry["flops"]["attention_split_softmax_pv"] == flops
    lg, kb = b * hq * s * kv * 4, b * hkv * kv * db * 2
    assert dry["bytes"]["attention_split_logits"] == \
        b * hq * s * db * 2 + kb + lg
    ws = tfa.split_pv_plan(b, hq, hkv, s, kv, db).workspace
    assert ws > 0
    assert dry["bytes"]["attention_split_softmax_pv"] == \
        lg + kb + b * hq * s * db * 2 + 2 * 4 * ws
    assert tops.launches() == dict.fromkeys(tops.LAUNCHES, 0)
    tops.reset_dry()


def test_wrappers_refuse_what_the_kernels_refuse():
    """kv_len outside [1, S], mixed dtypes, a head_dim block that is not
    a multiple of 4 (of 8 past 128), non-fp32 logits, a causal step
    without a position, and tensors on two devices raise."""
    q = torch.randn(1, 4, 1, 8)
    k = torch.randn(1, 2, 10, 8)
    with pytest.raises(ValueError, match="kv_len"):
        tfa.attention_split_check(q, k, 0)
    with pytest.raises(ValueError, match="kv_len"):
        tfa.attention_split_check(q, k, 11)
    with pytest.raises(ValueError, match="dtype"):
        tfa.attention_split_check(q, k.bfloat16(), 5)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfa.attention_split_check(q[..., :6], k[..., :6], 5)
    for db in (6, 132):
        with pytest.raises(ValueError, match="multiple of 4"):
            tfa.attention_split_pv_check(torch.randn(1, 4, 1, 5),
                                         torch.randn(1, 2, 10, db), 4, True)
    with pytest.raises(ValueError, match="fp32 logits"):
        tfa.attention_split_pv_check(torch.randn(1, 4, 1, 5).bfloat16(), k,
                                     4, True)
    with pytest.raises(ValueError, match="q_pos"):
        tfa.attention_split_pv_check(torch.randn(1, 4, 1, 5), k, -1, True)
    with pytest.raises(ValueError, match="tensors on"):
        tops.attention_split_logits(q, k.to("meta"), 5)

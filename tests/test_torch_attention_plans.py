"""How the port's flash attention kernel cuts its work, checked on the CPU.

``flash_attention.flash_plan`` is pure Python; ``csrc/flash_attention.cu``
derives its blocks, key ranges and splits from the same numbers and
refuses a plan it cannot run (the card tests hold it to that). These
tests hold the plan to what the kernel relies on, emulate the split-kv
partials and their merge in plain PyTorch against the plain version,
record the check that decided the precision of P on the tensor cores,
and hold the port's ``ops.attention`` on strided views against the JAX
reference's, run as its own tests run it (``pallas_interpret``).
"""
import itertools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(12)
#: phase 2's tolerance for bf16 attention (chip_smoke.py ``bf_tol``)
BF_TOL = (1e-2, 1e-2)


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _rows(plan, q_tile):
    """(row, head offset in the group, query, query position) of every
    valid row of the block at ``q_tile``, as the kernel maps them."""
    out = []
    for r in range(plan.gh * plan.qn):
        i = q_tile * plan.qn + r % plan.qn
        if i < plan.sq:
            out.append((r, r // plan.qn, i, plan.kv_len - plan.sq + i))
    return out


GRID = list(itertools.product(
    [1, 3],                                   # b
    [(8, 8), (8, 4), (8, 2), (8, 1)],         # hq, hkv: g 1, 2, 4, 8
    [(1, 56, 40), (1, 4096, 4000), (15, 77, 60), (65, 130, 40),
     (300, 301, 300), (4096, 4096, 4096), (2, 10, 0)],
    [64, 128],
    [torch.float32, torch.bfloat16]))


@pytest.mark.parametrize("b,heads,seq,d,dtype", GRID)
def test_flash_plan_fits_and_covers(b, heads, seq, d, dtype):
    """Shared memory within a block's 227 KB (48 KB static for fp32); the
    block's heads divide the group and its rows fit; every q tile's splits
    cover [0, visit) in order with no overlap, visit is kv_len for a
    block whose rows all have a valid key, and no key a row may take (<=
    its position and < kv_len) lies past it; below ``full`` every key is
    valid for every row (those tiles skip the mask)."""
    hq, hkv = heads
    sq, skv, kv_len = seq
    p = tfa.flash_plan(b, hq, hkv, sq, skv, kv_len, d, dtype)
    assert p.smem <= (tfa.MAX_SMEM if p.bf16 else tfa.STATIC_SMEM)
    assert p.g % p.gh == 0 and p.gh * p.qn <= p.rows
    assert p.rows == (16 * p.wr if p.bf16 else tfa.F32_ROWS)
    assert 1 <= p.splits <= tfa.MAX_SPLITS
    assert p.workspace == (p.splits * b * hq * sq * (d + 2)
                           if p.splits > 1 else 0)
    for t in range(p.q_tiles):
        visit, full = p.keys(t)
        ranges = p.split_ranges(t)
        assert len(ranges) == p.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == visit
        for (_, stop), (start, _) in zip(ranges, ranges[1:]):
            assert stop == start
        assert all(start <= stop and start % p.bk == 0
                   for start, stop in ranges)
        rows = _rows(p, t)
        assert rows
        if all(min(kv_len, pos + 1) > 0 for *_, pos in rows):
            assert visit == min(skv, kv_len, max(pos for *_, pos in rows)
                                + 1)
        else:                                 # a row with no valid key
            assert visit == skv
        for *_, pos in rows:
            assert min(pos, kv_len - 1, skv - 1) < visit
            assert full <= max(0, min(kv_len, pos + 1))


@pytest.mark.parametrize("args,want", [
    ((4, 32, 8, 1, 56, 40), (4, 1, 1, 1)),          # serving decode
    ((4, 32, 8, 1, 4096, 4000), (4, 1, 1, 4)),      # long cache: 4 splits
    ((1, 32, 8, 1, 2064, 2049), (4, 1, 1, 8)),      # phase 5 long prompt
    ((4, 32, 8, 32, 32, 32), (2, 32, 4, 1)),        # serving prefill
    ((1, 32, 8, 4096, 4096, 4096), (1, 128, 8, 1)),  # a real prompt
])
def test_flash_plan_at_the_path_shapes(args, want):
    """(gh, qn, wr, splits) at the serving path's bf16 shapes: a decode
    block stacks the group's 4 heads (4 of 16 rows), so each K/V tile is
    read once for them; the long caches split to one block per SM."""
    p = tfa.flash_plan(*args, 128, torch.bfloat16)
    assert (p.gh, p.qn, p.wr, p.splits) == want
    assert p.blocks <= tfa.SMS or p.splits == 1


def test_flash_constants_match_the_kernel_source():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for name, value in (("kTcKeys", tfa.TC_KEYS), ("kF32Keys", tfa.F32_KEYS),
                        ("kF32Rows", tfa.F32_ROWS), ("kPad", tfa.PAD),
                        ("kMaxSmem", tfa.MAX_SMEM),
                        ("kMaxSplits", tfa.MAX_SPLITS)):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(got.group(1)) == value, name


def _emulate_splits(q, k, v, kv_len, plan):
    """The kernel's split-kv partials in plain PyTorch (fp32): for every
    block and split, the base-2 online-softmax state (m, l, acc; acc as
    wide as v's head dim) of its key range under the reference's masks
    (-1e30; keys past the array excluded), laid out in the workspace as
    the kernel writes it."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    rows = b * hq * sq
    ws = torch.zeros(plan.splits * rows * (dv + 2))
    ml = ws[:2 * plan.splits * rows].view(plan.splits, rows, 2)
    acc = ws[2 * plan.splits * rows:].view(plan.splits, rows, dv)
    scale2 = d ** -0.5 * math.log2(math.e)
    for t in range(plan.q_tiles):
        for z, (k0, k1) in enumerate(plan.split_ranges(t)):
            kp = torch.arange(k0, k1)
            for _, jj, i, pos in _rows(plan, t):
                for bi in range(b):
                    for kvh in range(hkv):
                        for hb in range(plan.head_blocks):
                            h = kvh * g + hb * plan.gh + jj
                            s = (k[bi, kvh, k0:k1] @ q[bi, h, i]) * scale2
                            ok = (kp < kv_len) & (kp <= pos)
                            s = torch.where(ok, s, torch.full_like(s, -1e30))
                            m = torch.maximum(torch.tensor(-1e30), s.max()) \
                                if k1 > k0 else torch.tensor(-1e30)
                            p = torch.exp2(s - m)
                            row = (bi * hq + h) * sq + i
                            ml[z, row, 0], ml[z, row, 1] = m, p.sum()
                            acc[z, row] = p @ v[bi, kvh, k0:k1]
    return ws


@pytest.mark.parametrize("sq,skv,kv_len", [(1, 700, 650), (3, 700, 700),
                                           (1, 300, 300)])
def test_split_partials_merged_in_order_equal_the_plain_version(sq, skv,
                                                                kv_len):
    """Split-kv partials, emulated as the kernel forms them and merged by
    ``flash_merge_plain`` in split order, equal ``flash_attention_plain``
    within 1e-6 (fp32)."""
    b, hq, hkv, d = 2, 4, 2, 64
    q = torch.from_numpy(_np((b, hq, sq, d), 0.5))
    k = torch.from_numpy(_np((b, hkv, skv, d), 0.5))
    v = torch.from_numpy(_np((b, hkv, skv, d)))
    plan = tfa.flash_plan(b, hq, hkv, sq, skv, kv_len, d, torch.float32)
    assert plan.splits > 1
    ws = _emulate_splits(q, k, v, kv_len, plan)
    got = tfa.flash_merge_plain(ws, plan.splits, b, hq, sq, d)
    want = tfa.flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_rows_with_no_valid_key_average_every_key():
    """A row whose position is below 0 takes every key at -1e30 with
    weight 1, as the reference kernel does: the merge gives the mean of v
    over the whole array."""
    b, hq, hkv, sq, skv, kv_len, d = 1, 2, 1, 5, 300, 3, 64
    q = torch.from_numpy(_np((b, hq, sq, d)))
    k = torch.from_numpy(_np((b, hkv, skv, d)))
    v = torch.from_numpy(_np((b, hkv, skv, d)))
    plan = tfa.flash_plan(b, hq, hkv, sq, skv, kv_len, d, torch.float32)
    assert plan.keys(0)[0] == skv and plan.splits > 1
    ws = _emulate_splits(q, k, v, kv_len, plan)
    got = tfa.flash_merge_plain(ws, plan.splits, b, hq, sq, d)
    dead = sq - kv_len
    torch.testing.assert_close(
        got[:, :, :dead], v.mean(2, keepdim=True).expand(b, hq, dead, d),
        rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        got[:, :, dead:], tfa.flash_attention_plain(
            q, k, v, kv_len=kv_len)[:, :, dead:], rtol=1e-6, atol=1e-6)


def _p_rounding_share(b, hq, hkv, sq, skv, kv_len, d=128, heads=None):
    """The largest error that rounding P to one bf16 (before the PV
    product, l from the fp32 P) adds to the plain math, as a share of
    the bf16 tolerance, |o_bf16P - o| / (atol + rtol |o|), in fp32 before
    the output is rounded; inputs bf16 values, as phase 2 draws them."""
    g = hq // hkv
    q = torch.from_numpy(_np((b, hq, sq, d))).bfloat16().float()
    k = torch.from_numpy(_np((b, hkv, skv, d))).bfloat16().float()
    v = torch.from_numpy(_np((b, hkv, skv, d))).bfloat16().float()
    qpos = torch.arange(sq)[:, None] + kv_len - sq
    kpos = torch.arange(skv)[None, :]
    ok = (kpos <= qpos) & (kpos < kv_len)
    worst = 0.0
    for h in range(heads or hq):
        s = torch.einsum("bqd,bkd->bqk", q[:, h], k[:, h // g]) * d ** -0.5
        p = torch.exp(s.masked_fill(~ok, float("-inf"))
                      - s.masked_fill(~ok, float("-inf")).amax(-1, True))
        l = p.sum(-1, keepdim=True)
        o = p @ v[:, h // g] / l
        o2 = p.bfloat16().float() @ v[:, h // g] / l
        share = (o2 - o).abs() / (BF_TOL[1] + BF_TOL[0] * o.abs())
        worst = max(worst, float(share.max()))
    return worst


@pytest.mark.parametrize("shape", [(4, 32, 8, 32, 32, 32),
                                   (4, 32, 8, 1, 56, 40),
                                   (4, 32, 8, 1, 4096, 4000),
                                   (1, 32, 8, 1024, 1024, 1024)])
def test_one_bf16_p_is_enough(shape):
    """The check that chose one bf16 P on the tensor cores (no hi + lo
    split): at phase 2's bf16 shapes (the 4096-token prefill cut to 1024
    tokens and 4 heads to keep the CPU time short) rounding P to bf16
    adds under half of the bf16 tolerance. Measured: 0.31 at the serving
    prefill, 0.12 at its decode, 0.02 at the long decode."""
    heads = 4 if shape[3] > 32 else None
    assert _p_rounding_share(*shape, heads=heads) < 0.5


@pytest.mark.parametrize("hq,hkv,sq,skv,kv_len", [(4, 2, 64, 128, 128),
                                                  (8, 8, 64, 128, 100),
                                                  (4, 1, 128, 256, None)])
def test_strided_views_against_the_reference(hq, hkv, sq, skv, kv_len):
    """q and v as the (b, s, h, d) projections viewed as (b, h, s, d), k
    contiguous, through the port's ``ops.attention`` against the JAX
    reference's on contiguous copies of the same values (its Pallas
    kernel in interpret mode), at the reference's tolerances."""
    b, d = 2, 64
    q = _np((b, sq, hq, d), 0.2)
    k = _np((b, hkv, skv, d), 0.2)
    v = _np((b, skv, hkv, d))
    tq = torch.from_numpy(q).transpose(1, 2)
    tv = torch.from_numpy(v).transpose(1, 2)
    assert not tq.is_contiguous()
    with jops.backend("pallas_interpret"):
        want = jops.attention(jnp.asarray(q.transpose(0, 2, 1, 3)),
                              jnp.asarray(k),
                              jnp.asarray(v.transpose(0, 2, 1, 3)),
                              causal=True, kv_len=kv_len)
    got = tops.attention(tq, torch.from_numpy(k), tv, causal=True,
                         kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)



# ----------------------------------------------------------------------
# MLA's (q/k 192, v 128) route
# ----------------------------------------------------------------------
MLA_GRID = list(itertools.product(
    [1, 4],                                   # b
    [(16, 16), (16, 4)],                      # deepseek's MHA; a GQA group
    [(32, 32, 32), (1, 56, 40), (1, 2064, 2049), (2048, 2048, 2048),
     (65, 130, 40)],
    [torch.float32, torch.bfloat16]))


@pytest.mark.parametrize("b,heads,seq,dtype", MLA_GRID)
def test_mla_plan_sizes_by_v_head_dim(b, heads, seq, dtype):
    """Shared memory: the Q rows and K ring at 192 and the V ring and the
    merge staging at 128 (bf16, within a block's 227 KB), the fp32
    route's 53 KB (past the 48 KiB static limit: the launch opts in); the
    split workspace holds (m, l) and a 128-wide accumulator a row; the
    split ranges cover every key the rows take, as at equal dims."""
    hq, hkv = heads
    sq, skv, kv_len = seq
    p = tfa.flash_plan(b, hq, hkv, sq, skv, kv_len, 192, dtype, dv=128)
    assert (p.d, p.dv) == (192, 128)
    if p.bf16:
        ring = 2 * (16 * p.wr * 200 + p.stages * 64 * (200 + 136))
        stage = 4 * (16 * tfa.tc_warps(p.wr) * 132 + 2 * 16 *
                     tfa.tc_warps(p.wr))
        assert p.smem == max(ring, stage) <= tfa.MAX_SMEM
    else:
        assert p.smem == 4 * (16 * 192 + 32 * 193 + 32 * 128) == 53376
        assert p.smem > tfa.STATIC_SMEM
    assert p.workspace == (p.splits * b * hq * sq * 130 if p.splits > 1
                           else 0)
    for t in range(p.q_tiles):
        visit, _ = p.keys(t)
        ranges = p.split_ranges(t)
        assert ranges[0][0] == 0 and ranges[-1][1] == visit
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))


def test_mla_plans_at_the_path_shapes():
    """deepseek's served shapes (bf16, 16 heads of one group each): the
    prefill chunk of 2 x 32 tokens, the 2048-token prompt (128-row
    blocks, 180 KB), a decode step over 56 slots and the long prompt's
    decode, whose 16 blocks split 8 ways."""
    bf = torch.bfloat16
    pre = tfa.flash_plan(2, 16, 16, 32, 32, 32, 192, bf, dv=128)
    assert (pre.gh, pre.qn, pre.wr, pre.splits) == (1, 32, 2, 1)
    long = tfa.flash_plan(1, 16, 16, 2048, 2048, 2048, 192, bf, dv=128)
    assert (long.qn, long.wr, long.splits, long.smem) == (128, 8, 1, 180224)
    dec = tfa.flash_plan(4, 16, 16, 1, 56, 40, 192, bf, dv=128)
    assert (dec.gh, dec.qn, dec.splits) == (1, 1, 1)
    ldec = tfa.flash_plan(1, 16, 16, 1, 2064, 2049, 192, bf, dv=128)
    assert ldec.splits == 8 and ldec.blocks <= tfa.SMS


@pytest.mark.parametrize("d,dv", [(192, 64), (128, 64), (64, 128),
                                  (192, 192), (48, 32), (96, 96)])
def test_other_head_pairs_are_refused(d, dv):
    """Only the instantiated pairs plan; any other raises ValueError (the
    card never sends a pair to the plain version)."""
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_plan(1, 4, 4, 8, 8, 8, d, torch.bfloat16, dv=dv)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_bwd_plan(1, 4, 4, 8, 8, d, torch.bfloat16, True, dv)


def test_head_pairs_match_the_kernel_source():
    """``HEAD_PAIRS`` is the kernels' ``head_pair`` in both sources."""
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        src = (_build.CSRC / name).read_text()
        body = re.search(r"constexpr bool head_pair\(int \w+, int \w+\) "
                         r"\{(.*?)\}", src, re.S).group(1)
        pairs = {(int(a), int(b)) for a, b in re.findall(
            r"\(\w+ == (\d+) && \w+ == (\d+)\)", body)}
        assert pairs == set(tfa.HEAD_PAIRS), name


@pytest.mark.parametrize("sq,skv,kv_len", [(1, 700, 650), (2, 500, 480)])
def test_mla_split_partials_merged_in_order(sq, skv, kv_len):
    """At (192, 128): the split partials, emulated as the kernel forms
    them (128-wide accumulators), merged by ``flash_merge_plain`` at dv
    128 in split order, equal ``flash_attention_plain`` within 1e-6."""
    b, hq, hkv = 1, 4, 4
    q = torch.from_numpy(_np((b, hq, sq, 192), 0.3))
    k = torch.from_numpy(_np((b, hkv, skv, 192), 0.3))
    v = torch.from_numpy(_np((b, hkv, skv, 128)))
    plan = tfa.flash_plan(b, hq, hkv, sq, skv, kv_len, 192, torch.float32,
                          dv=128)
    assert plan.splits > 1
    ws = _emulate_splits(q, k, v, kv_len, plan)
    assert ws.numel() == plan.workspace
    got = tfa.flash_merge_plain(ws, plan.splits, b, hq, sq, 128)
    want = tfa.flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    assert got.shape == (b, hq, sq, 128)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sq,skv,kv_len", [(32, 32, None), (1, 30, 17)])
def test_mla_shapes_against_the_reference(sq, skv, kv_len):
    """MLA's call, q / k of 192 and v of 128 as a strided view, through the
    port's ``ops.attention`` against the reference's (its plain ``ref.mha``
    on every backend for unequal dims) at its tolerance."""
    b, h = 2, 4
    q = _np((b, h, sq, 192), 0.2)
    k = _np((b, h, skv, 192), 0.2)
    v = _np((b, skv, h, 128))
    with jops.backend("pallas_interpret"):
        want = jops.attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v.transpose(0, 2, 1, 3)),
                              causal=True, scale=192 ** -0.5, kv_len=kv_len)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v).transpose(1, 2), causal=True,
                         scale=192 ** -0.5, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

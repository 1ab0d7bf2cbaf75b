"""How the port's flash attention backward cuts its work, checked on the CPU.

``flash_attention.flash_bwd_plan`` is pure Python;
``csrc/flash_attention_bwd.cu`` recomputes the same plan and refuses any
other (the card tests hold it to that). These tests hold the plan to what
the kernel relies on at the shapes of the dense configurations (llama3-8b,
yi-9b, phi3-medium-14b, granite-3-8b): every (batch, kv head, key tile,
query head) in exactly one dK/dV block, a GQA group's splits contiguous in
head order, the causal bound, shared memory, a grid that fills the card,
and they emulate the group splits' fp32 partials, added in split order as
the merge launch adds them, against the plain version.
"""
import itertools
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa

RNG = np.random.default_rng(15)

#: (b, hq, hkv) of the dense configurations' attention at training
#: width: llama3-8b at phase 11's batch, yi-9b's group of 8 at batch 2,
#: phi3-medium-14b's 40 / 10 heads, granite-3-8b
SHAPES = {"path": (4, 32, 8), "yi": (2, 32, 4), "phi3": (1, 40, 10),
          "granite": (1, 32, 8)}
GRID = list(itertools.product(SHAPES, [2048, 1000, 130], [64, 128],
                              [torch.float32, torch.bfloat16],
                              [True, False]))


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _blocks(p):
    x_n, y_n = p.dkdv_grid
    for x in range(x_n):
        for y in range(y_n):
            yield x, y, p.dkdv_block(x, y)


@pytest.mark.parametrize("shape,s,d,dtype,causal", GRID)
def test_bwd_plan_covers_fits_and_fills(shape, s, d, dtype, causal):
    """Every (batch, kv head, key tile, query head) in exactly one dK/dV
    block; a group's splits contiguous in head order (split z takes heads
    z g/gs .. (z+1) g/gs - 1 of the group); each block's first query tile
    the first that holds an admitted (query, key) pair; shared memory
    within a block's 227 KB; the dK/dV grid at least one block a slot
    (132 SMs; fp32 4 blocks an SM) wherever b hkv g key tiles allow."""
    b, hq, hkv = SHAPES[shape]
    g = hq // hkv
    p = tfa.flash_bwd_plan(b, hq, hkv, s, s, d, dtype, causal)
    assert g % p.gs == 0
    assert max(p.smem_dkdv, p.smem_dq) <= tfa.MAX_SMEM
    seen = {}
    for x, y, (bi, kvh, split, heads, keys, tiles) in _blocks(p):
        assert list(heads) == list(range(kvh * g + split * (g // p.gs),
                                         kvh * g + (split + 1) * (g // p.gs)))
        assert keys.start == y * p.bk and len(keys) > 0
        for h in heads:
            key = (bi, kvh, y, h)
            assert key not in seen, key
            seen[key] = x
        # tiles before the first hold no admitted pair, the first one does
        if causal and tiles.start > 0:
            assert (tiles.start * p.bq - 1) < keys.start
        if causal:
            assert min(s - 1, tiles.start * p.bq + p.bq - 1) >= keys.start
        assert tiles.stop == -(-s // p.bq)
    nkt = -(-s // p.bk)
    assert len(seen) == b * hkv * nkt * g
    slots = tfa.SMS * (1 if p.bf16 else tfa.F32_BWD_BLOCKS_PER_SM)
    blocks = p.dkdv_grid[0] * p.dkdv_grid[1]
    assert blocks >= min(slots, b * hkv * g * nkt)
    assert p.dq_grid == (b * hq, -(-s // p.dq_rows))
    assert p.ws_bytes == (2 * p.gs * b * hkv * s * d * 4 if p.gs > 1 else 0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bwd_plan_is_a_pure_function_of_the_shape(shape):
    """Two plans of one shape are equal with the planner's cache cleared
    between them (no device query, no state), so remat and the card
    tests see the kernel cut the same work the same way."""
    b, hq, hkv = SHAPES[shape]
    args = (b, hq, hkv, 2048, 2048, 128, torch.bfloat16, True)
    first = tfa.flash_bwd_plan(*args)
    tfa.flash_bwd_plan.cache_clear()
    assert tfa.flash_bwd_plan(*args) == first
    assert tfa.group_split(b, hkv, hq // hkv, 2048, 2048, first.bk,
                           first.bq, True, tfa.SMS) == first.gs


def test_bwd_plan_at_the_path_shapes():
    """The path shape keeps whole groups (gs 1, no workspace, no merge);
    yi's group of 8 splits in two, which halves its longest block (8 x 32
    query tiles for 128 slots' worth of 132); the fp32 case of b 1, hkv 2,
    s 1000 takes 4 splits, 256 dK/dV blocks where it had 64."""
    p = tfa.flash_bwd_plan(4, 32, 8, 2048, 2048, 128, torch.bfloat16)
    assert (p.bk, p.bq, p.dq_rows, p.dq_keys, p.stages, p.warpgroups,
            p.gs) == (128, 64, 128, 64, 3, 2, 1)
    assert (p.dkdv_grid, p.dq_grid, p.ws_bytes) == ((32, 16), (128, 16), 0)
    assert (p.smem_dkdv, p.smem_dq) == (166456, 165944)
    yi = tfa.flash_bwd_plan(2, 32, 4, 2048, 2048, 128, torch.bfloat16)
    assert yi.gs == 2 and yi.dkdv_grid == (16, 16)
    f = tfa.flash_bwd_plan(1, 8, 2, 1000, 1000, 128, torch.float32)
    assert (f.bk, f.bq, f.gs, f.dkdv_grid) == (32, 16, 4, (8, 32))


@pytest.mark.parametrize("args,match", [
    ((1, 8, 2, 64, 64, 96, torch.bfloat16), "head dim"),
    ((1, 8, 2, 64, 64, 128, torch.float16), "fp32 or bf16"),
    ((1, 8, 3, 64, 64, 128, torch.bfloat16), "shapes"),
    ((1, 8, 2, 0, 64, 128, torch.bfloat16), "shapes"),
    ((1, 8, 2, 65, 64, 128, torch.bfloat16), "sq <= skv"),
])
def test_bwd_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        tfa.flash_bwd_plan(*args)


def test_bwd_constants_match_the_kernel_source():
    """The planner's tiles, ring, warpgroups, row table and SM count are
    the kernel's constants (the kernel recomputes the plan from them)."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for name, value in (("kWG", tfa.BWD_WARPGROUPS), ("kBq", tfa.BWD_ROWS),
                        ("kDqKeys", tfa.BWD_DQ_KEYS),
                        ("kStages", tfa.BWD_STAGES),
                        ("kF32BwdKeys", tfa.F32_BWD_KEYS),
                        ("kF32BwdRows", tfa.F32_BWD_ROWS),
                        ("kF32BlocksPerSm", tfa.F32_BWD_BLOCKS_PER_SM),
                        ("kSms", tfa.SMS), ("kTile", tfa.BWD_ROW_TILE),
                        ("kMaxSmem", tfa.MAX_SMEM)):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert got and int(got.group(1)) == value, name
    assert re.search(r"constexpr int kBk = 64 \* kWG;", src)
    assert re.search(r"constexpr int kDqRows = 64 \* kWG;", src)
    assert tfa.BWD_KEYS == tfa.BWD_DQ_ROWS == 64 * tfa.BWD_WARPGROUPS


def _emulate_dkdv(q, k, v, o, lse, do, plan, scale):
    """dK and dV as the kernel's blocks form them, in plain PyTorch (fp32):
    each block's partial over its heads and query tiles (P = 2^(S scale
    log2 e - lse log2 e) under the causal mask and the ragged edges, dS =
    P (dP - D)), written per split into the workspace's layout (gs, b,
    hkv, skv, d) for dK and (gs, b, hkv, skv, dv) for dV, and added in
    split order, dK times scale, as the merge launch adds them."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ws_k = torch.zeros(plan.gs, b, hkv, skv, d)
    ws_v = torch.zeros(plan.gs, b, hkv, skv, v.shape[-1])
    delta = (do * o).sum(-1)
    lse2 = lse * math.log2(math.e)
    scale2 = scale * math.log2(math.e)
    for _, _, (bi, kvh, split, heads, keys, tiles) in _blocks(plan):
        kp = torch.arange(keys.start, keys.stop)
        q0 = tiles.start * plan.bq
        qi = torch.arange(q0, sq)
        kb, vb = k[bi, kvh, keys.start:keys.stop], v[bi, kvh, keys.start:
                                                      keys.stop]
        for h in heads:
            s = kb @ q[bi, h, q0:].T * scale2
            ok = kp[:, None] <= (skv - sq) + qi[None, :] if plan.causal \
                else torch.ones(len(kp), len(qi), dtype=torch.bool)
            pt = torch.where(ok, torch.exp2(s - lse2[bi, h, q0:]),
                             torch.zeros(()))
            dpt = vb @ do[bi, h, q0:].T
            dst = pt * (dpt - delta[bi, h, q0:])
            ws_k[split, bi, kvh, keys.start:keys.stop] += dst @ q[bi, h, q0:]
            ws_v[split, bi, kvh, keys.start:keys.stop] += pt @ do[bi, h, q0:]
    dk, dv = ws_k[0].clone(), ws_v[0].clone()
    for z in range(1, plan.gs):
        dk, dv = dk + ws_k[z], dv + ws_v[z]
    return dk * scale, dv


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,causal", [
    (1, 8, 2, 130, 64, torch.float32, True),
    (1, 8, 2, 130, 64, torch.bfloat16, True),
    (1, 8, 2, 130, 128, torch.bfloat16, False),
    (2, 16, 2, 300, 64, torch.bfloat16, True),
    (1, 8, 2, 1000, 64, torch.float32, True),
])
def test_group_split_partials_summed_in_split_order_equal_the_plain_version(
        b, hq, hkv, s, d, dtype, causal):
    """The group splits' partials, emulated as the plan's blocks form them
    (the plan of ``dtype``; arithmetic in fp32) and added in split order,
    equal ``flash_attention_bwd_plain``'s dK and dV within 1e-5."""
    plan = tfa.flash_bwd_plan(b, hq, hkv, s, s, d, dtype, causal)
    assert plan.gs > 1
    q = torch.from_numpy(_np((b, hq, s, d), 0.5))
    k = torch.from_numpy(_np((b, hkv, s, d), 0.5))
    v = torch.from_numpy(_np((b, hkv, s, d)))
    do = torch.from_numpy(_np((b, hq, s, d)))
    o = tfa.flash_attention_plain(q, k, v, causal=causal)
    lse = tfa.flash_lse_plain(q, k, causal=causal)
    dk, dv = _emulate_dkdv(q, k, v, o, lse, do, plan, d ** -0.5)
    _, want_k, want_v = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal=causal)
    torch.testing.assert_close(dk, want_k, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, want_v, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# MLA's (q/k 192, v 128) route
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,s,dtype,causal", list(itertools.product(
    [(1, 16, 16), (4, 16, 16), (2, 16, 2)], [2048, 300],
    [torch.float32, torch.bfloat16], [True, False])))
def test_mla_bwd_plan_sizes_by_v_head_dim(shape, s, dtype, causal):
    """At (192, 128): the bf16 blocks hold K / Q tiles at 192 and V / dO
    tiles at 128 (dK/dV 207 416 bytes, dQ 206 904, within 227 KB), the
    fp32 blocks rows of 193 and 129 floats; the workspace holds dK's
    partials at 192 and dV's at 128; the blocks cover every (batch, kv
    head, key tile, query head) once."""
    b, hq, hkv = shape
    p = tfa.flash_bwd_plan(b, hq, hkv, s, s, 192, dtype, causal, 128)
    assert (p.d, p.dv) == (192, 128)
    if p.bf16:
        assert (p.smem_dkdv, p.smem_dq) == (207416, 206904)
    else:
        assert p.smem_dkdv == 4 * (32 * 322 + 16 * 322) + 8 * 32 * 17 + 128
        assert p.smem_dq == 4 * (16 * 322 + 32 * 322) + 4 * 16 * 33 + 128
    assert max(p.smem_dkdv, p.smem_dq) <= tfa.MAX_SMEM
    assert p.ws_bytes == (p.gs * b * hkv * s * 320 * 4 if p.gs > 1 else 0)
    g = hq // hkv
    seen = set()
    for _, y, (bi, kvh, _, heads, _, _) in _blocks(p):
        for h in heads:
            assert (bi, kvh, y, h) not in seen
            seen.add((bi, kvh, y, h))
    assert len(seen) == b * hkv * g * -(-s // p.bk)


def test_mla_bwd_plan_at_the_path_shape():
    """deepseek's backward at b 1, 16 heads, s 2048 (bf16): whole groups
    (MHA: g 1), 16 x 16 dK/dV blocks, no workspace."""
    p = tfa.flash_bwd_plan(1, 16, 16, 2048, 2048, 192, torch.bfloat16, True,
                           128)
    assert (p.gs, p.dkdv_grid, p.dq_grid, p.ws_bytes) == (1, (16, 16),
                                                          (16, 16), 0)


@pytest.mark.parametrize("b,hq,hkv,s,dtype,causal", [
    (1, 8, 2, 130, torch.float32, True),
    (1, 8, 2, 300, torch.bfloat16, True),
    (1, 8, 2, 130, torch.bfloat16, False)])
def test_mla_group_split_partials_equal_the_plain_version(b, hq, hkv, s,
                                                          dtype, causal):
    """The group splits' partials at (192, 128), emulated as the plan's
    blocks form them and added in split order, equal the plain version's
    dK (192 wide) and dV (128 wide) within 1e-5."""
    plan = tfa.flash_bwd_plan(b, hq, hkv, s, s, 192, dtype, causal, 128)
    assert plan.gs > 1
    q = torch.from_numpy(_np((b, hq, s, 192), 0.4))
    k = torch.from_numpy(_np((b, hkv, s, 192), 0.4))
    v = torch.from_numpy(_np((b, hkv, s, 128)))
    do = torch.from_numpy(_np((b, hq, s, 128)))
    o = tfa.flash_attention_plain(q, k, v, causal=causal)
    lse = tfa.flash_lse_plain(q, k, causal=causal)
    dk, dv = _emulate_dkdv(q, k, v, o, lse, do, plan, 192 ** -0.5)
    _, want_k, want_v = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal=causal)
    assert dk.shape[-1] == 192 and dv.shape[-1] == 128
    torch.testing.assert_close(dk, want_k, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, want_v, rtol=1e-5, atol=1e-5)

"""The plans of the SSD scan kernel (``ssd_scan.scan_plan``) and of the
fused AdamW kernel (``ntx_elementwise.adamw_plan``), and the bf16 work
route of the port's chunked SSD oracle against the reference's.

The kernels take their plans as launch arguments and run only on the
card; these tests hold the plans to what the kernels rely on (every
output covered by exactly one block or thread, shared memory within a
block's budget, the Python constants equal to the ones compiled into
``csrc/``), on the CPU.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ntx_elementwise as tew
from repro_torch.kernels import ref, ssd_scan

CSRC = Path(ssd_scan.__file__).resolve().parent / "csrc"


def _const(source: str, name: str) -> int:
    got = re.search(rf"constexpr int {name} = (\d+);",
                    (CSRC / source).read_text())
    return int(got.group(1))


# ----------------------------------------------------------------------
# SSD
# ----------------------------------------------------------------------
def test_ssd_constants_match_the_kernel_source():
    assert _const("ssd_scan.cuh", "kMaxChunk") == ssd_scan.MAX_CHUNK
    assert _const("ssd_scan.cuh", "kMaxHeads") == ssd_scan.MAX_HEADS
    assert _const("ssd_scan.cuh", "kPad") == ssd_scan.PAD
    assert _const("ssd_scan.cuh", "kThreads") == ssd_scan.THREADS
    assert _const("ssd_scan.cuh", "kMaxSmem") == ssd_scan.MAX_SMEM


_SHAPES = [(8, 1024, 64, 64, 128, 128), (1, 1000, 3, 64, 128, 128),
           (1, 200, 11, 32, 32, 64), (2, 96, 2, 16, 32, 16),
           (1, 130, 4, 128, 128, 128), (1, 77, 3, 48, 40, 50),
           (3, 1, 9, 20, 16, 7)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,l,h,dh,n,chunk", _SHAPES)
def test_ssd_plan_covers_each_output_once(bf16, b, l, h, dh, n, chunk):
    """Walk passes 1 and 3's grid as ``tile_of`` in csrc/ssd_scan.cu
    reads it: every (batch, step, head, head-dim column) is written by
    exactly one block, and each block's chunk fits the padded tile. Pass
    2's grid covers every (batch, head, state element) once."""
    p = ssd_scan.scan_plan(b, l, h, dh, n, chunk, bf16)
    assert p.lp % (16 if bf16 else 32) == 0 and chunk <= p.lp <= 128
    assert p.np % 16 == 0 and n <= p.np < n + 16
    assert p.dtile in ssd_scan.D_TILES[bf16]
    assert p.nc * chunk >= l > (p.nc - 1) * chunk
    count = np.zeros((b, l, h, dh), np.int32)
    blocks = 0
    for c in range(p.nc):
        for bi in range(b):
            for z in range(p.head_groups * p.d_tiles):
                h0 = (z // p.d_tiles) * p.heads
                nh = min(p.heads, h - h0)
                d0 = (z % p.d_tiles) * p.dtile
                t0 = c * chunk
                Lc = min(chunk, l - t0)
                assert 1 <= nh <= p.heads and 1 <= Lc <= p.lp
                assert 0 <= d0 < dh
                count[bi, t0:t0 + Lc, h0:h0 + nh, d0:d0 + p.dtile] += 1
                blocks += 1
    assert (count == 1).all()
    assert blocks == p.blocks(b)
    nd = n * dh
    grid2 = -(-nd // ssd_scan.THREADS)
    assert (grid2 - 1) * ssd_scan.THREADS < nd <= grid2 * ssd_scan.THREADS


def test_ssd_plan_at_the_training_shape():
    """mamba2-1.3b at batch 8 x 1024: C B^T shared by 8 heads, the whole
    head dim in one tile, 512 blocks per pass."""
    p = ssd_scan.scan_plan(8, 1024, 64, 64, 128, 128, True)
    assert (p.lp, p.np, p.dtile, p.heads) == (128, 128, 64, 8)
    assert (p.nc, p.head_groups, p.d_tiles, p.blocks(8)) == (8, 8, 1, 512)
    assert (p.smem_state, p.smem_out) == (98304, 116736)
    q = ssd_scan.scan_plan(8, 1024, 64, 64, 128, 128, False)
    assert (q.lp, q.dtile, q.smem_out) == (128, 64, 208896)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("chunk", [1, 16, 50, 64, 100, 128])
@pytest.mark.parametrize("n", [16, 32, 100, 128, 256])
@pytest.mark.parametrize("dh", [16, 48, 64, 128])
def test_ssd_plan_fits_shared_memory(bf16, chunk, n, dh):
    """A plan the planner returns fits a block's 227 KB in both passes,
    as ``smem_bytes`` counts it; where nothing fits it raises."""
    try:
        p = ssd_scan.scan_plan(2, 300, 12, dh, n, chunk, bf16)
    except ValueError:
        rows = 16 if bf16 else 32
        narrowest = ssd_scan.D_TILES[bf16][0]
        assert max(ssd_scan.smem_bytes(
            bf16, -(-chunk // rows) * rows, -(-n // 16) * 16, narrowest,
            ssd_scan.HEADS_PER_BLOCK)) > ssd_scan.MAX_SMEM
        return
    got = ssd_scan.smem_bytes(bf16, p.lp, p.np, p.dtile, p.heads)
    assert got == (p.smem_state, p.smem_out)
    assert max(got) <= ssd_scan.MAX_SMEM
    # the widest tile that fits: the next one up would not, or covers dh
    wider = [t for t in ssd_scan.D_TILES[bf16] if t > p.dtile]
    if wider and p.dtile < dh:
        assert max(ssd_scan.smem_bytes(bf16, p.lp, p.np, wider[0],
                                       p.heads)) > ssd_scan.MAX_SMEM


@pytest.mark.parametrize("args", [
    dict(chunk=0), dict(chunk=129), dict(dh=0), dict(dh=129), dict(n=0),
    dict(n=4096), dict(b=-1)])
def test_ssd_plan_refuses_what_the_kernel_cannot_run(args):
    shape = dict(b=1, l=256, h=4, dh=64, n=128, chunk=128)
    shape.update(args)
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            ssd_scan.scan_plan(**shape, bf16=bf16)


@pytest.mark.parametrize("l,chunk", [(128, 32), (64, 64), (96, 16)])
def test_chunked_bf16_work_route_matches_reference(l, chunk):
    """The port's chunked oracle with ``work_dtype=bfloat16`` (W, dt x and
    the state operands rounded to bf16 before their products, as the
    reference's non-Pallas training route computes) against the
    reference's ``ssd_scan_chunked(work_dtype=jnp.bfloat16)`` on the
    reference's own SSD inputs (``tests/test_kernels.py::test_ssd_sweep``:
    dt in [0.01, 0.2], A in [-2, -0.5]). Both round the same fp32 values
    and differ only where a value formed in another summation order
    lands on the other side of a bf16 rounding boundary (measured: at
    most 2.7e-5), so they are held to 1e-4; the bf16 rounding itself
    moves the result by 2.2e-3 to 3.0e-3 from the fp32 route, which the
    last check pins."""
    rng = np.random.default_rng(42)
    b, h, dh, n = 2, 3, 16, 32
    x = rng.standard_normal((b, l, h, dh)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    arrs = (x, dt, A, B, C)
    got = ref.ssd_scan_chunked(*(torch.from_numpy(a) for a in arrs),
                               chunk=chunk, work_dtype=torch.bfloat16)
    want = jref.ssd_scan_chunked(*(jnp.asarray(a) for a in arrs),
                                 chunk=chunk, work_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-4)
    f32 = ref.ssd_scan_chunked(*(torch.from_numpy(a) for a in arrs),
                               chunk=chunk)
    assert float((f32 - got).abs().max()) > 1e-3


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def test_adamw_constants_match_the_kernel_source():
    assert _const("ntx_adamw.cu", "kThreads") == tew.ADAMW_THREADS
    assert _const("ntx_adamw.cu", "kUnroll") == tew.ADAMW_UNROLL


def _walk(n, plan, threads):
    """The elements each route of ``adamw_kernel`` touches, as it indexes
    them: the element loop over head and tail, the vector loop."""
    seen = np.zeros(n, np.int32)
    singles = plan.head + plan.tail
    body_end = plan.head + 4 * plan.vecs
    for i in range(singles):                 # any thread, grid-strided
        e = i if i < plan.head else body_end + (i - plan.head)
        seen[e] += 1
    for i in range(plan.vecs):
        seen[plan.head + 4 * i:plan.head + 4 * i + 4] += 1
    return seen


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 1001, 4099,
                               65539])
@pytest.mark.parametrize("phases", [(0,) * 7, (1,) * 7, (2,) * 7, (3,) * 7,
                                    (0, 1, 2, 3, 0, 0, 0), (1,) * 6 + (0,),
                                    (2, 0, 0, 0, 0, 0, 0)])
def test_adamw_plan_covers_each_element_once(n, phases):
    """Head, vectors and tail cover every element once; the vectors start
    on a 4-element boundary of every operand, or there are none; the grid
    has work for every block and at most ADAMW_BLOCKS_PER_SM per SM."""
    plan = tew.adamw_plan(n, phases, 132)
    assert plan.head + 4 * plan.vecs + plan.tail == n
    assert min(plan.head, plan.vecs, plan.tail) >= 0
    assert (_walk(n, plan, 256) == 1).all()
    if len(set(phases)) == 1:
        assert plan.head == min(n, -phases[0] % 4) and plan.tail < 4
        if plan.vecs:
            assert (phases[0] + plan.head) % 4 == 0
    else:
        assert (plan.head, plan.vecs, plan.tail) == (n, 0, 0)
    assert 1 <= plan.blocks <= 132 * tew.ADAMW_BLOCKS_PER_SM
    work = max(-(-plan.vecs // (tew.ADAMW_UNROLL * tew.ADAMW_THREADS)),
               -(-(plan.head + plan.tail) // tew.ADAMW_THREADS), 1)
    assert plan.blocks == min(work, 132 * tew.ADAMW_BLOCKS_PER_SM)


def test_adamw_plan_at_the_path_shapes():
    """A 2048x4096 layer and the 50432x2048 embedding, fresh (aligned):
    vectors only; the layer's grid gives each block one pass of
    ADAMW_UNROLL vectors a thread, the embedding's is capped at
    ADAMW_BLOCKS_PER_SM blocks per SM and strides."""
    per_block = tew.ADAMW_UNROLL * tew.ADAMW_THREADS
    for shape in ((2048, 4096), (50432, 2048)):
        n = shape[0] * shape[1]
        plan = tew.adamw_plan(n, (0,) * 7, 132)
        assert (plan.head, plan.vecs, plan.tail) == (0, n // 4, 0)
        assert plan.blocks == min(n // 4 // per_block,
                                  132 * tew.ADAMW_BLOCKS_PER_SM)
    assert tew.adamw_plan(2048 * 4096, (0,) * 7, 132).blocks == 2048
    assert tew.adamw_plan(50432 * 2048, (0,) * 7, 132).blocks == 2112


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_outputs_take_the_inputs_phase(phase, dtype):
    like = torch.zeros(37, dtype=dtype)
    out = tew._empty_at(like, phase, dtype)
    assert out.shape == like.shape and out.dtype == dtype
    assert out.is_contiguous() and tew._phase(out) == phase

"""The fused Laplace's plain version and the conv kernel's tile plan, on
the CPU.

``ntx_stencil.laplace_plain`` is what the fused ``ntx_laplace`` kernel is
held to bit for bit on the card; here it is held bit for bit to the
reference's Pallas route (``repro.kernels.ops.laplace`` in
``pallas_interpret``: per-axis passes over the interior slices, summed in
axis order). The [1, -2, 1] products are exact, so XLA's contraction of
the Pallas tap loop cannot move them.

``ntx_conv.tile_plan`` cuts a plane into output tiles, its taps into
chunks and its tiles over the grid, and ``csrc/ntx_conv.cu`` runs the
plan it is given; these tests hold the plan to what the kernel relies on.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ntx_conv as tconv
from repro_torch.kernels import ntx_stencil as tst
from repro_torch.kernels import ops as tops

RNG_SEED = 10


def _np(shape, seed):
    rng = np.random.default_rng((RNG_SEED, seed))
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------------
# The Laplace's plain version against the reference's Pallas route
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300,), (37,), (40, 50), (3, 17),
                                   (12, 14, 16), (3, 9, 5), (7, 3, 11),
                                   (4, 5, 3, 6)])
def test_laplace_plain_matches_pallas_interpret(shape, dtype):
    """Ragged 1-D, 2-D and 3-D shapes, an axis of exactly 3, a 4-D
    shape, fp32 and bf16 inputs: bit for bit."""
    x = _np(shape, len(shape))
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x, jnp.bfloat16)
        # both sides widen the same bf16 values
        assert np.array_equal(xt.float().numpy(),
                              np.asarray(xj.astype(jnp.float32)))
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    with jops.backend("pallas_interpret"):
        want = np.asarray(jops.laplace(xj))
    got = tst.laplace_plain(xt)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tst.laplace_shape(shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2,), (1, 7), (5, 2), (6, 2, 4),
                                   (4, 3, 2, 5), (3, 3, 3)])
def test_laplace_shape_matches_the_plain_route(shape):
    """The card route returns an empty interior of ``laplace_shape`` for
    an axis shorter than 3: the shape the plain route gives."""
    got = tst.laplace_plain(torch.ones(shape))
    assert tuple(got.shape) == tst.laplace_shape(shape)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("shape", [(50,), (20, 30), (6, 7, 8),
                                   (4, 5, 6, 3)])
def test_ops_laplace_cpu_route_is_the_plain_version(shape):
    x = torch.from_numpy(_np(shape, 7))
    tops.reset_launches()
    got = tops.laplace(x)
    assert torch.equal(got, tst.laplace_plain(x))
    assert all(v == 0 for v in tops.launches().values())


# ----------------------------------------------------------------------
# The conv kernel's tile plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("oh,ow", [(254, 254), (250, 250), (8190, 8190),
                                   (8186, 8186), (3, 3), (1, 50), (50, 1),
                                   (68, 101), (101, 36), (130, 67),
                                   (1000, 129), (33, 1025)])
def test_tiles_cover_every_output_once(oh, ow):
    """The tiles, at the origins the kernel computes, cover each output
    of a ragged (oh, ow) plane exactly once, and none is empty."""
    plan = tconv.tile_plan(oh, ow, 3, 3)
    assert plan.tile_w == tconv.RUN_W * plan.tx
    assert plan.tile_h == plan.rpt * plan.ty
    assert plan.threads <= 256 and plan.threads % 32 == 0
    seen = np.zeros((oh, ow), np.int32)
    for t in range(plan.tiles):
        y0, x0 = plan.tile_origin(t)
        assert y0 < oh and x0 < ow
        seen[y0:y0 + plan.tile_h, x0:x0 + plan.tile_w] += 1
    assert (seen == 1).all()
    assert plan.blocks == plan.tiles            # one block per tile


@pytest.mark.parametrize("oh,ow,k,blocks", [
    (254, 254, 3, 7), (1096, 1026, 5, 64), (1018, 1018, 7, 264),
    (59, 91, 7, 1), (8186, 8186, 7, 264)])
def test_a_persistent_grid_takes_every_tile_once(oh, ow, k, blocks):
    """With fewer blocks than tiles, block b takes tiles b, b + blocks,
    ...: every tile once, and the blocks' loads differ by at most one."""
    plan = tconv.tile_plan(oh, ow, k, k)
    plan = plan._replace(blocks=min(blocks, plan.tiles))
    blocks = plan.blocks
    taken = [t for b in range(blocks) for t in plan.block_tiles(b)]
    assert sorted(taken) == list(range(plan.tiles))
    counts = [len(plan.block_tiles(b)) for b in range(blocks)]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("hw", [256, 8192])
def test_plan_fills_the_card(k, hw):
    """A 256^2 plane (the paper's Figure-5 size) gets at least one tile
    per SM of an H100; an 8192^2 plane gets the largest tile."""
    plan = tconv.tile_plan(hw - k + 1, hw - k + 1, k, k)
    assert plan.tiles >= tconv.MIN_TILES
    if hw == 8192:
        assert (plan.tx, plan.ty, plan.rpt) == tconv.PLANS[0]
    assert (plan.ci, plan.cj) == (k, k)          # no chunks


@pytest.mark.parametrize("h,w,kh,kw", [
    (70, 300, 3, 200), (400, 40, 300, 5), (2000, 1400, 3, 700),
    (1200, 300, 500, 3), (2100, 2100, 2000, 1), (64, 4000, 1, 3000),
    (9, 9, 7, 7), (8192, 8192, 7, 7)])
def test_tap_chunks_fit_the_stage_and_keep_the_order(h, w, kh, kw):
    """Every chunk's halo tile and taps fit one ring stage; the chunks
    cover each tap once, rows outer and columns inner (so each output
    still adds its taps i outer, j inner); a column chunk is one tap row
    of a multiple of 4 columns, so its copies stay 16-byte aligned."""
    plan = tconv.tile_plan(h - kh + 1, w - kw + 1, kh, kw)
    assert plan.stage == tconv.stage_floats(plan.tile_h, plan.tile_w,
                                            plan.ci, plan.cj)
    assert plan.stage <= tconv.STAGE_FLOATS
    if plan.cj < kw:
        assert plan.ci == 1 and plan.cj % 4 == 0
    order = []
    for i0, ci, j0, cj in plan.chunks(kh, kw):
        assert tconv.stage_floats(plan.tile_h, plan.tile_w, ci, cj) <= (
            tconv.STAGE_FLOATS)
        order += [(i, j) for i in range(i0, i0 + ci)
                  for j in range(j0, j0 + cj)]
    assert order == [(i, j) for i in range(kh) for j in range(kw)]
    if plan.ci > 1:
        assert plan.cj == kw


def test_large_taps_are_chunked():
    """The card tests past a stage: the 300 x 5 taps in row chunks; a
    3 x 700 tap block on a plane large enough for the largest tile, in
    column chunks."""
    assert len(tconv.tile_plan(101, 36, 300, 5).chunks(300, 5)) > 1
    plan = tconv.tile_plan(1998, 701, 3, 700)
    assert (plan.tx, plan.ty, plan.rpt) == tconv.PLANS[0]
    assert plan.cj < 700 and len(plan.chunks(3, 700)) > 3

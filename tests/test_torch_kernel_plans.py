"""How the port's CUDA kernels cut their work, checked on the CPU.

The bf16 GEMM's split-k plan (``ntx_gemm.split_k_plan``) and the streaming
kernel's row chunks (``ntx_elementwise.stream_chunks``) are pure Python;
the kernels in ``csrc/`` derive their loops from the same numbers. These
tests hold the plans to what the kernels rely on, and the Python
constants to the ones compiled into the sources.
"""
import re

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import ntx_elementwise as tew
from repro_torch.kernels import ntx_gemm as tgemm

#: llama3-8b's MLP products as the serving path runs them, (m, n, k):
#: gate and w1 (4096 -> 14336), w2 (14336 -> 4096), at decode (m = 4)
#: and prefill (m = 128)
PATH_SHAPES = [(4, 14336, 4096), (4, 4096, 14336), (128, 14336, 4096),
               (128, 4096, 14336)]
SHAPES = PATH_SHAPES + [(1, 90, 1007), (3, 90, 300), (70, 1003, 1007),
                        (16, 1000, 14336), (17, 8, 64), (5, 7, 1), (2, 3, 0),
                        (4096, 4096, 4096)]


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_split_k_ranges_cover_k_in_order(m, n, k):
    """The splits' k ranges start at 0, follow one another with no gap or
    overlap, end at k, begin on the kernel's k tile, and each holds at
    least MIN_SPLIT_K_TILES tiles when there is more than one split."""
    plan = tgemm.split_k_plan(m, n, k)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, stop), (start, _) in zip(ranges, ranges[1:]):
        assert stop == start
    for start, stop in ranges:
        assert start % plan.bk == 0 and start <= stop
        if plan.splits > 1:
            assert stop - start >= min(
                k - start, tgemm.MIN_SPLIT_K_TILES * plan.bk)
    assert plan.splits <= tgemm.MAX_SPLITS
    assert plan.k_tiles == -(-k // plan.bk)


@pytest.mark.parametrize("m,n,k", PATH_SHAPES)
def test_split_k_plan_fills_the_card_at_the_path_shapes(m, n, k):
    """Every decode and prefill MLP product runs as one wave of at most
    one block per SM of an H100 (132), and covers most SMs: w2 (32 output
    tiles) is split four ways into 128 blocks; gate and w1 (112 tiles)
    are not split. The workspace holds one fp32 partial per split and
    output element."""
    plan = tgemm.split_k_plan(m, n, k)
    assert 0.8 * tgemm.SMS <= plan.blocks <= tgemm.SMS
    assert plan.splits == (4 if n == 4096 else 1)
    assert plan.workspace == (plan.splits * m * n if plan.splits > 1 else 0)
    assert plan.tile == (0 if m <= 16 else 1)


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_split_k_plan_is_a_function_of_the_shape(m, n, k):
    plan = tgemm.split_k_plan(m, n, k)
    assert plan == tgemm.split_k_plan(m, n, k)
    assert plan.m_tiles * plan.bm >= m and plan.n_tiles * plan.bn >= n
    if plan.splits == 1:
        assert plan.workspace == 0


def test_tc_tiles_match_the_kernel_source():
    """TC_TILES lists csrc/ntx_gemm.cu's TileSmall and TileLarge (BM, BN,
    BK) in that order: the plan's k tiles are the kernel's."""
    src = _source("ntx_gemm.cu")
    tiles = []
    for name in ("TileSmall", "TileLarge"):
        got = re.search(rf"using {name} = TcTile<(\d+), (\d+), (\d+),", src)
        tiles.append(tuple(int(v) for v in got.groups()))
    assert tuple(tiles) == tgemm.TC_TILES


def test_stream_chunk_matches_the_kernel_source():
    got = re.search(r"constexpr int kChunk = (\d+);", _source("ntx_stream.cu"))
    assert int(got.group(1)) == tew.STREAM_CHUNK


@pytest.mark.parametrize("n", [0, 1, tew.STREAM_CHUNK - 1, tew.STREAM_CHUNK,
                               tew.STREAM_CHUNK + 1, 128256, (1 << 20) + 3,
                               1 << 22])
def test_stream_chunks_depend_on_n_alone(n):
    """A reduction tail splits a row into ceil(n / STREAM_CHUNK) chunks
    (one for an empty row): the chunking, and so the order in which a SUM
    is added, is fixed by n whatever the chain before it or the number
    of rows."""
    chunks = tew.stream_chunks(n)
    assert chunks == max(1, -(-n // tew.STREAM_CHUNK))
    assert (chunks - 1) * tew.STREAM_CHUNK < max(n, 1) <= (
        chunks * tew.STREAM_CHUNK)


@pytest.mark.parametrize("m,n,compensated,tile", [
    (4096, 4096, True, 2),       # the suite's 4096^3: 1024 blocks
    (4096, 4096, False, 2),
    (128, 128, True, 1),         # 128x2048x128 x100: 1 block at 128 x 128
    (1024, 1024, True, 1),       # the exact-slab case: 64 blocks
    (12 * 128, 11 * 128, False, 2),   # exactly one block per SM
    (12 * 128, 11 * 128 - 1, False, 2),
    (12 * 128, 10 * 128, False, 1),   # 120 blocks: less than a wave
    (16, 1 << 16, False, 0),     # m <= 16 keeps the 16 x 128 tile
    (17, 1 << 16, True, 2),
])
def test_ffma_plan_picks_the_large_tile_by_wave(m, n, compensated, tile):
    """The register-tiled 128-row tile where it gives at least one block
    per SM (``SMS``), the 64 x 64 tile below that, the 16 x 128 tile for
    m <= 16; k never changes the tile."""
    for k in (1, 128, 4096):
        plan = tgemm.ffma_plan(m, n, k, compensated)
        assert plan.tile == tile
        assert plan.blocks == -(-m // plan.bm) * -(-n // plan.bn)
        if tile == 2:
            assert plan.blocks >= tgemm.SMS and plan.bm == 128


@pytest.mark.parametrize("m", [17, 4096])
def test_ffma_plan_keeps_the_64_tile_for_bf16_inputs(m):
    """The compensated GEMM of bf16 inputs keeps today's 64 x 64 template
    whatever its size."""
    assert tgemm.ffma_plan(m, 4096, 4096, True, bf16=True).tile == 1


def test_ffma_tiles_match_the_kernel_source():
    """FFMA_TILES[2] is csrc/ntx_gemm.cu's FfmaLarge (BM 128, TM 8), and
    kSms the SM count its tile rule uses; the kernel refuses a tile other
    than the one that rule (ffma_tile, the planner's rule) gives, so a
    plan built from other numbers is refused on the card."""
    src = _source("ntx_gemm.cu")
    bn, tn, st = (int(v) for v in re.search(
        r"using FfmaLarge = FfmaTile<(\d+), (\d+), (\d+)>;", src).groups())
    assert tgemm.FFMA_TILES[2] == (128, bn, 8, tn, st)
    assert int(re.search(r"constexpr int kSms = (\d+);", src).group(1)) == \
        tgemm.SMS
    assert "tile != ffma_tile(m, n, in_bf16 != 0)" in src

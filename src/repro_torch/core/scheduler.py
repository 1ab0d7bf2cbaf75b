"""Tile scheduling: the paper's double-buffered DMA scheme (§II-E).

Counterpart of ``repro.core.scheduler``. Kernels are subdivided into
tiles that fit the scratchpad (TCDM on silicon, shared memory on the
H100). The DMA copies tile i+1 in while the engines compute tile i and
copies tile i-1 out — compute and data movement fully overlap, so the
steady-state time per tile is max(compute, dma). The ``schedule_*``
functions are the paper's cluster arithmetic, carried over as they are
for the perf model (``repro_torch.perfmodel.ntx``);
:func:`pick_matmul_blocks` sizes a GEMM block tile against one H100
thread block's shared memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Tile:
    """One double-buffered tile: bytes in/out and flops of compute."""

    bytes_in: int
    bytes_out: int
    flops: int


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    tiles: List[Tile]
    buffer_bytes: int            # per-buffer footprint (x2 when double buffered)

    @property
    def total_flops(self) -> int:
        return sum(t.flops for t in self.tiles)

    @property
    def total_bytes(self) -> int:
        return sum(t.bytes_in + t.bytes_out for t in self.tiles)

    def time_s(self, peak_flops: float, peak_bw: float,
               overlap: bool = True, setup_cycles: int = 0,
               freq_hz: float = 1.0) -> float:
        """Steady-state pipelined execution time.

        With double buffering (``overlap=True``) each tile costs
        max(compute, dma); without, the costs add. ``setup_cycles`` models
        the per-command offload overhead (amortised, paper §II-E).
        """
        t = 0.0
        setup = setup_cycles / freq_hz
        for tile in self.tiles:
            tc = tile.flops / peak_flops + setup
            td = (tile.bytes_in + tile.bytes_out) / peak_bw
            t += max(tc, td) if overlap else (tc + td)
        # pipeline fill: first dma not overlapped
        if overlap and self.tiles:
            t += self.tiles[0].bytes_in / peak_bw
        return t


def split_even(n: int, tile: int) -> List[int]:
    """Split n into chunks of at most ``tile``."""
    return [min(tile, n - i) for i in range(0, n, tile)]


# ----------------------------------------------------------------------
# Kernel-specific tilings (paper §III-B) — used by the perf model
# ----------------------------------------------------------------------
def schedule_axpy(n: int, scratch_bytes: int, elem: int = 4) -> TileSchedule:
    """y = a*x + y: stream x and y in, y out. 3 buffers per element."""
    per_elem = 3 * elem
    tile_n = max(1, scratch_bytes // (2 * per_elem))  # /2: double buffering
    tiles = [Tile(2 * elem * c, elem * c, 2 * c) for c in split_even(n, tile_n)]
    return TileSchedule(tiles, buffer_bytes=tile_n * per_elem)


def schedule_gemv(m: int, n: int, scratch_bytes: int, elem: int = 4) -> TileSchedule:
    """y = A x: tile rows; x cached once per tile (worst case re-streamed)."""
    row_bytes = n * elem
    rows_per_tile = max(1, scratch_bytes // (2 * (row_bytes + elem)) )
    tiles = []
    for r in split_even(m, rows_per_tile):
        tiles.append(Tile(bytes_in=r * row_bytes + n * elem,
                          bytes_out=r * elem, flops=2 * r * n))
    return TileSchedule(tiles, buffer_bytes=rows_per_tile * row_bytes)


def schedule_gemm(m: int, n: int, k: int, scratch_bytes: int,
                  elem: int = 4) -> TileSchedule:
    """Block matmul: square-ish blocks sized to the scratchpad.

    Per output block (bm x bn): stream A panel (bm x k) and B panel
    (k x bn), write block out. Block size chosen so A+B panels for one k-slab
    plus the C block fit in half the scratchpad.
    """
    b = int(math.sqrt(scratch_bytes / (2 * 3 * elem)))
    b = max(1, min(b, m, n, k))
    tiles = []
    for bm in split_even(m, b):
        for bn in split_even(n, b):
            tiles.append(Tile(bytes_in=(bm + bn) * k * elem,
                              bytes_out=bm * bn * elem,
                              flops=2 * bm * bn * k))
    return TileSchedule(tiles, buffer_bytes=3 * b * b * elem)


def schedule_conv2d(h: int, w: int, kh: int, kw: int, scratch_bytes: int,
                    elem: int = 4, c_in: int = 1,
                    c_out: int = 1) -> TileSchedule:
    """Valid 2-D convolution, tiled by rows (halo = kh-1 rows).

    DNN-style multi-channel conv (paper §III-B2): each input row strip is
    read once per tile and reused across ``c_out`` output channels (the NTX
    hardware loops cover kw, kh, c_in, out-col; the host iterates rows and
    output channels within the TCDM-resident tile)."""
    row_bytes = w * elem * c_in
    rows_per_tile = max(kh, scratch_bytes // (2 * 2 * row_bytes))
    out_h = h - kh + 1
    out_w = w - kw + 1
    tiles = []
    done = 0
    while done < out_h:
        r = min(rows_per_tile - (kh - 1), out_h - done)
        r = max(1, r)
        tiles.append(Tile(
            bytes_in=(r + kh - 1) * row_bytes + kh * kw * c_in * c_out * elem,
            bytes_out=r * out_w * c_out * elem,
            flops=2 * r * out_w * kh * kw * c_in * c_out))
        done += r
    return TileSchedule(tiles, buffer_bytes=rows_per_tile * row_bytes)


def schedule_stencil(shape: Tuple[int, ...], points: int, scratch_bytes: int,
                     elem: int = 4) -> TileSchedule:
    """Star-shaped stencil, decomposed per dimension (paper §III-B3)."""
    n = 1
    for s in shape:
        n *= s
    tile_n = max(1, scratch_bytes // (2 * 2 * elem))
    tiles = [Tile(2 * elem * c, elem * c, 2 * points * c)
             for c in split_even(n, tile_n)]
    return TileSchedule(tiles, buffer_bytes=tile_n * 2 * elem)


# ----------------------------------------------------------------------
# Shared-memory block sizing for a GEMM on the H100
# ----------------------------------------------------------------------
#: dynamic shared memory one H100 thread block may opt into (227 KiB)
SMEM_PER_BLOCK = 227 * 1024
#: the tensor-core instruction ``csrc/ntx_gemm.cu`` issues,
#: ``mma.sync.m16n8k16``: its (m, n, k)
MMA_TILE = (16, 8, 16)
#: the largest block tile ``csrc/ntx_gemm.cu`` runs (``TileLarge``)
MAX_BLOCK = (128, 128, 64)
#: bytes each shared-memory row is padded by (``kAStride``/``kBStride``)
ROW_PAD_BYTES = 16


def _ring_bytes(bm: int, bn: int, bk: int, dtype_bytes: int,
                stages: int) -> int:
    """Bytes of a ``stages``-deep ring of A (bm x bk) and B (bk x bn)
    tiles with every row padded by ``ROW_PAD_BYTES``."""
    a_row = bk * dtype_bytes + ROW_PAD_BYTES
    b_row = bn * dtype_bytes + ROW_PAD_BYTES
    return stages * (bm * a_row + bk * b_row)


def pick_matmul_blocks(m: int, n: int, k: int, dtype_bytes: int = 4,
                       stages: int = 3,
                       smem_bytes: int = SMEM_PER_BLOCK
                       ) -> Tuple[int, int, int]:
    """(bm, bn, bk) block tile whose ``stages``-deep shared-memory ring of
    A and B tiles fits one H100 thread block.

    Alignment: bm a multiple of 16, bn of 8 and bk of 16, the m, n and k
    of ``mma.sync.m16n8k16`` — the H100 analogue of the paper's banking
    constraint. Start at the largest tile ``csrc/ntx_gemm.cu`` runs (128 x
    128 x 64), cut to the problem rounded up to that alignment, then
    halve bk, and then the larger of bm and bn, until the ring (rows
    padded by 16 bytes, as the kernel pads them) fits ``smem_bytes``.
    bf16 at m <= 16 gives the kernel's decode tile (16 x 128 x 64), at
    larger m its 128 x 128 x 64 tile."""
    am, an, ak = MMA_TILE
    up = lambda x, a: max(a, -(-x // a) * a)
    bm = min(MAX_BLOCK[0], up(m, am))
    bn = min(MAX_BLOCK[1], up(n, an))
    bk = min(MAX_BLOCK[2], up(k, ak))

    def fits(bm, bn, bk):
        return _ring_bytes(bm, bn, bk, dtype_bytes, stages) <= smem_bytes

    while not fits(bm, bn, bk) and bk > ak:
        bk = max(ak, bk // 2 // ak * ak)
    while not fits(bm, bn, bk) and max(bm // am, bn // an) > 1:
        if bm // am >= bn // an:
            bm = max(am, bm // 2 // am * am)
        else:
            bn = max(an, bn // 2 // an * an)
    return bm, bn, bk

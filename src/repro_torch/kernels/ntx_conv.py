"""NTX direct 2-D convolution (paper §III-B2): the plain version and the
launcher of ``csrc/ntx_conv.cu``.

Counterpart of ``repro.kernels.ntx_conv``: the valid correlation of one
(h, w) plane with (kh, kw) taps, the taps run i outer, j inner over an
fp32 accumulator (the PCS register), rounded once at the store. The
Pallas kernel takes one halo-overlapped strip per call and the host cuts
the strips; the CUDA kernel covers the whole plane in one launch, its
grid of output tiles taking the place of the host's strip loop.

:func:`tile_plan` cuts the plane for the kernel (its tile, its block of
threads, its tap chunks, its grid) and the launcher passes the plan on;
the kernel refuses a plan it cannot run.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, ref

_IMG_DTYPES = (torch.float32, torch.bfloat16)


def conv2d_plain(img: torch.Tensor, ker: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_conv_kernel``: ``acc = acc + ker[i, j] *
    img[i:i+oh, j:j+ow]``, i outer, j inner, in fp32, each product rounded
    before its add (``ref.conv2d``). img (h, w) any float dtype."""
    return ref.conv2d(img, ker)


#: output columns per thread and the floats of one ring stage (the
#: kernel's ``kRunW`` and ``kStageFloats``: it refuses a larger stage);
#: the tile count a plan must reach (one per SM of an H100); the tile
#: shapes (threads along x, threads along y, rows per thread), largest
#: first
RUN_W = 4
MIN_TILES = 132
STAGE_FLOATS = 12 * 1024
PLANS = ((64, 4, 8), (32, 4, 8), (16, 4, 8), (8, 8, 1), (8, 4, 1))


def _round4(v: int) -> int:
    return (v + 3) & ~3


def stage_floats(th: int, tw: int, ci: int, cj: int) -> int:
    """Floats of one ring stage: the (th + ci - 1) x (tw + cj - 1) halo
    tile (rows padded to 4) and the ci x cj taps (rows padded to 4)."""
    return (th + ci - 1) * _round4(tw + cj - 1) + ci * _round4(cj)


class ConvPlan(NamedTuple):
    tx: int          # threads along x, each RUN_W output columns
    ty: int          # threads along y, each rpt output rows
    rpt: int
    tile_h: int
    tile_w: int
    x_tiles: int
    tiles: int
    ci: int          # tap rows per chunk
    cj: int          # tap columns per chunk
    stage: int       # floats per ring stage
    blocks: int      # the grid: block b takes tiles b, b + blocks, ...

    @property
    def threads(self) -> int:
        return self.tx * self.ty

    def tile_origin(self, t: int) -> tuple:
        """(row, column) of tile t's first output, as the kernel finds it."""
        ty = t // self.x_tiles
        return ty * self.tile_h, (t - ty * self.x_tiles) * self.tile_w

    def block_tiles(self, b: int) -> range:
        """The tiles block b computes, in its order."""
        return range(b, self.tiles, self.blocks)

    def chunks(self, kh: int, kw: int) -> list:
        """The tap chunks in the order the kernel applies them:
        (i0, ci, j0, cj), row chunks outer, column chunks inner."""
        return [(i0, min(self.ci, kh - i0), j0, min(self.cj, kw - j0))
                for i0 in range(0, kh, self.ci)
                for j0 in range(0, kw, self.cj)]


@functools.lru_cache(maxsize=256)
def tile_plan(oh: int, ow: int, kh: int, kw: int) -> ConvPlan:
    """The kernel's plan for an (oh, ow) output and (kh, kw) taps: the
    first of PLANS whose tiles number at least MIN_TILES (else the last),
    then the largest tap chunk that fits STAGE_FLOATS: whole tap rows, or
    one row of a multiple of 4 columns (so each output still adds its
    taps i outer, j inner, and the copies stay 16-byte aligned). One
    block per tile: a persistent grid (``blocks`` < ``tiles``) runs too,
    but was slower."""
    for tx, ty, rpt in PLANS:
        tw, th = RUN_W * tx, rpt * ty
        x_tiles = -(-ow // tw)
        tiles = x_tiles * -(-oh // th)
        if tiles >= MIN_TILES:
            break
    ci = 0
    while ci < kh and stage_floats(th, tw, ci + 1, kw) <= STAGE_FLOATS:
        ci += 1
    cj = kw
    if ci == 0:
        ci, cj = 1, 4
        while cj + 4 <= kw and stage_floats(th, tw, 1, cj + 4) <= (
                STAGE_FLOATS):
            cj += 4
    return ConvPlan(tx, ty, rpt, th, tw, x_tiles, tiles, ci, cj,
                    stage_floats(th, tw, ci, cj), tiles)


def check_shapes(img: torch.Tensor, ker: torch.Tensor) -> None:
    if img.dim() != 2 or ker.dim() != 2:
        raise ValueError(f"conv2d takes an (h, w) plane and (kh, kw) taps, "
                         f"got {tuple(img.shape)} and {tuple(ker.shape)}")
    if not (1 <= ker.shape[0] <= img.shape[0]
            and 1 <= ker.shape[1] <= img.shape[1]):
        raise ValueError(f"taps {tuple(ker.shape)} do not fit the plane "
                         f"{tuple(img.shape)}")


def conv2d_cuda(img: torch.Tensor, ker: torch.Tensor,
                plan: ConvPlan | None = None) -> torch.Tensor:
    """Launch ``csrc/ntx_conv.cu``: img (h, w) fp32 or bf16 (widened on
    load), ker (kh, kw) taps (taken as fp32), out (h-kh+1, w-kw+1) fp32,
    cut by ``plan`` (default :func:`tile_plan`; another plan is passed
    only to time the choice, the ``ops`` entry points never do)."""
    check_shapes(img, ker)
    if img.dtype not in _IMG_DTYPES:
        raise ValueError(f"ntx_conv reads fp32 or bf16 planes, not "
                         f"{img.dtype}")
    h, w = img.shape
    kh, kw = ker.shape
    if not img.is_contiguous():
        img = img.contiguous()
    if ker.dtype != torch.float32 or not ker.is_contiguous():
        ker = ker.to(torch.float32).contiguous()
    oh, ow = h - kh + 1, w - kw + 1
    p = plan or tile_plan(oh, ow, kh, kw)
    out = torch.empty((oh, ow), dtype=torch.float32, device=img.device)
    with _build.on_device(img):
        code = _build.library().ntx_conv2d(
            img.data_ptr(), ker.data_ptr(), out.data_ptr(), h, w, kh, kw,
            int(img.dtype == torch.bfloat16), p.tx, p.ty, p.rpt, p.ci, p.cj,
            p.blocks, _build.stream_of(img))
    _build.check(code, "ntx_conv2d")
    return out

"""NTX streaming GEMM with fused store epilogues: the plain version and
the launcher of ``csrc/ntx_gemm.cu``.

Counterpart of ``repro.kernels.ntx_gemm``: ``C = epilogue(A @ B)`` with
an fp32 accumulator rounded once at the store (the PCS wide
accumulator, the descriptor's store_level). The epilogue stages run on
the fp32 accumulator in the store step, in order, before the single
write. ``compensated=True`` (``_gemm_kernel_kahan``) carries a Neumaier
compensation term across slabs of k and adds it before the epilogue.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build
from .ref import f32

#: Epilogue stage kinds that carry a streamed array operand (in order).
EPILOGUE_ARRAY_KINDS = ("bias", "residual", "mul", "sub", "mask")
#: All supported epilogue kinds.
EPILOGUE_KINDS = EPILOGUE_ARRAY_KINDS + ("scale", "relu", "thresh",
                                         "silu", "gelu")
#: kind numbers as ``csrc/ntx_gemm.cu`` has them
_KIND = {k: i for i, k in enumerate(EPILOGUE_KINDS)}
#: stages the kernel takes per launch
MAX_EPILOGUE = 16
#: depth of the k slabs the compensated GEMM sums exactly-then-compensates
#: (the default block_k of gemm_pallas; ``kKahanSlab`` in the kernel).
#: The result depends on it, so both routes use this one width.
KAHAN_SLAB = 128


def apply_epilogue(acc: torch.Tensor, stages, operands) -> torch.Tensor:
    """Apply fused epilogue stages to the fp32 accumulator.

    ``stages``: tuple of (kind, imm). ``operands``: one tensor per array
    kind, in stage order. ``silu`` is ``acc * sigmoid(acc)``; ``gelu`` is
    the tanh approximation (``jax.nn.gelu``'s default), never PyTorch's
    exact-erf default."""
    i = 0
    for kind, imm in stages:
        if kind == "bias":           # + row vector broadcast over rows
            acc = acc + operands[i].reshape(
                *acc.shape[:-2], 1, acc.shape[-1]).float()
            i += 1
        elif kind == "residual":     # + full matrix
            acc = acc + operands[i].float()
            i += 1
        elif kind == "mul":          # * full matrix (e.g. a gate)
            acc = acc * operands[i].float()
            i += 1
        elif kind == "sub":          # - full matrix (SUB: acc - rd1)
            acc = acc - operands[i].float()
            i += 1
        elif kind == "mask":         # MASK: keep acc where rd1 != 0
            acc = torch.where(operands[i] != 0, acc, torch.zeros_like(acc))
            i += 1
        elif kind == "scale":
            acc = acc * f32(imm)
        elif kind == "relu":
            acc = torch.clamp_min(acc, 0.0)
        elif kind == "thresh":
            acc = torch.where(acc > f32(imm), acc, torch.zeros_like(acc))
        elif kind == "silu":
            acc = acc * torch.sigmoid(acc)
        elif kind == "gelu":
            acc = F.gelu(acc, approximate="tanh")
        else:
            raise ValueError(kind)
    return acc


def gemm_plain(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32,
               epilogue=()) -> torch.Tensor:
    """Plain version of ``gemm_pallas``: fp32 product, epilogue on the
    fp32 accumulator, one rounding to ``out_dtype``. ``epilogue``: the
    normalized (kind, imm, operand) triples. (L, m, k) @ (L, k, n) with
    (L, n) / (L, m, n) operands is L lanes, as the reference's vmap runs
    the Pallas call."""
    acc = a.float() @ b.float()
    stages = tuple((kind, imm) for kind, imm, _ in epilogue)
    operands = [op for kind, _, op in epilogue
                if kind in EPILOGUE_ARRAY_KINDS]
    return apply_epilogue(acc, stages, operands).to(out_dtype)


def kahan_add(acc: torch.Tensor, comp: torch.Tensor, x: torch.Tensor):
    """One Neumaier step: returns (acc', comp'). ``|acc| >= |x|`` picks
    the branch whose rounding error is exact."""
    t = acc + x
    comp = comp + torch.where(acc.abs() >= x.abs(), (acc - t) + x,
                              (x - t) + acc)
    return t, comp


def gemm_kahan_plain(a: torch.Tensor, b: torch.Tensor,
                     out_dtype=torch.float32, epilogue=()) -> torch.Tensor:
    """Plain version of ``gemm_pallas(compensated=True)``: each
    KAHAN_SLAB-deep slab's fp32 product ``a[:, s] @ b[s, :]`` is
    Neumaier-added into ``(acc, comp)`` as ``_gemm_kernel_kahan`` adds its
    k blocks; the epilogue runs on ``acc + comp``, rounded once."""
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    comp = torch.zeros_like(acc)
    for s in range(0, k, KAHAN_SLAB):
        x = a[:, s:s + KAHAN_SLAB].float() @ b[s:s + KAHAN_SLAB].float()
        acc, comp = kahan_add(acc, comp, x)
    stages = tuple((kind, imm) for kind, imm, _ in epilogue)
    operands = [op for kind, _, op in epilogue
                if kind in EPILOGUE_ARRAY_KINDS]
    return apply_epilogue(acc + comp, stages, operands).to(out_dtype)


_GEMM_DTYPES = (torch.float32, torch.bfloat16)

#: the bf16 tensor-core route's block tiles (BM, BN, BK), indexed as
#: ``csrc/ntx_gemm.cu`` numbers them (``TileSmall``, ``TileLarge``)
TC_TILES = ((16, 128, 64), (128, 128, 64))
#: SMs of an H100 SXM. A split-k grid holds at most one block per SM:
#: on an H100 two per SM were slower at four of the six serving shapes
#: and level at a fifth (chip_smoke phase 3 times each path shape both
#: ways; prefill w1 is the one faster with them)
SMS = 132
#: fewest k tiles a split takes (enough to fill the kernel's 3- or
#: 4-stage copy ring), and most splits
MIN_SPLIT_K_TILES = 4
MAX_SPLITS = 32


@dataclasses.dataclass(frozen=True)
class SplitKPlan:
    """How the bf16 tensor-core route cuts one (m, n, k) product: the
    block tile, its grid, the number of k splits and the fp32 workspace
    (elements) that holds their partials."""

    tile: int
    bm: int
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    splits: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def k_ranges(self, k: int) -> list:
        """The ``[start, stop)`` range of k each split sums, in split
        order, as the kernel derives it from its block index: split z
        takes k tiles ``[z kt // splits, (z + 1) kt // splits)``."""
        kt, s = self.k_tiles, self.splits
        return [(min(k, z * kt // s * self.bk),
                 min(k, (z + 1) * kt // s * self.bk)) for z in range(s)]


@functools.lru_cache(maxsize=1024)
def split_k_plan(m: int, n: int, k: int) -> SplitKPlan:
    """The bf16 route's tile and k split for an (m, k) @ (k, n) product, a
    pure function of the shape: the 16-row tile for m <= 16, else the
    128-row one; as many k splits as fit the grid in one block per SM
    (``SMS``), but no split shorter than ``MIN_SPLIT_K_TILES`` k tiles
    and at most ``MAX_SPLITS``. With more than one split the partials
    take ``splits * m * n`` fp32 of workspace."""
    tile = 0 if m <= TC_TILES[0][0] else 1
    bm, bn, bk = TC_TILES[tile]
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    k_tiles = -(-k // bk)
    want = SMS // max(1, m_tiles * n_tiles)
    splits = max(1, min(want, k_tiles // MIN_SPLIT_K_TILES, MAX_SPLITS))
    return SplitKPlan(tile=tile, bm=bm, bn=bn, bk=bk, m_tiles=m_tiles,
                      n_tiles=n_tiles, k_tiles=k_tiles, splits=splits,
                      workspace=splits * m * n if splits > 1 else 0)


#: the FFMA route's tiles, as ``csrc/ntx_gemm.cu`` numbers them: (BM, BN,
#: TM, TN, STAGES) of the 16 x 128 tile (m <= 16), the 64 x 64 one, and
#: the register-tiled 128-row tile of fp32 inputs (``FfmaLarge``)
FFMA_TILES = ((16, 128, 2, 4, 1), (64, 64, 4, 4, 1), (128, 128, 8, 8, 3))


@dataclasses.dataclass(frozen=True)
class FfmaPlan:
    """How the FFMA route (fp32 inputs, and any compensated product) cuts
    one (m, n, k) product: the tile ``csrc/ntx_gemm.cu`` numbers ``tile``,
    its shape and the grid's blocks."""

    tile: int
    bm: int
    bn: int
    tm: int
    tn: int
    stages: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def ffma_plan(m: int, n: int, k: int, compensated: bool,
              bf16: bool = False) -> FfmaPlan:
    """The FFMA route's tile for an (m, k) @ (k, n) product, a pure
    function of the shape (``k`` and ``compensated`` do not change it:
    both variants run the same tiles): the 16 x 128 tile for m <= 16;
    for fp32 inputs, the register-tiled 128-row tile where its grid holds
    at least one block per SM (``SMS``), else the 64 x 64 tile (``bf16``:
    the compensated product of bf16 inputs, which keeps the 64 x 64
    tile). The kernel refuses any other tile."""
    del k, compensated
    if m <= 16:
        tile = 0
    else:
        bm, bn = FFMA_TILES[2][:2]
        tile = 2 if not bf16 and -(-m // bm) * -(-n // bn) >= SMS else 1
    bm, bn, tm, tn, stages = FFMA_TILES[tile]
    return FfmaPlan(tile=tile, bm=bm, bn=bn, tm=tm, tn=tn, stages=stages,
                    blocks=-(-m // bm) * -(-n // bn))


@functools.lru_cache(maxsize=256)
def _encode_epilogue(stages: tuple) -> tuple:
    """The kernel's (kinds, imms, operand-is-bf16) arrays for (kind, imm,
    operand dtype or None) stages, made once per epilogue signature: the
    serving path issues the same three at every layer."""
    return (_build.ptr_array(ctypes.c_int, [_KIND[k] for k, _, _ in stages]),
            _build.ptr_array(ctypes.c_float, [f32(i) for _, i, _ in stages]),
            _build.ptr_array(ctypes.c_int, [int(dt == torch.bfloat16)
                                            for _, _, dt in stages]))


def _lane_operand(t: torch.Tensor, shape, what: str) -> tuple:
    """``(t, lane stride)`` for an operand of ``lanes`` matrices of
    ``shape[1:]``: each lane's matrix contiguous, the lanes at any stride
    that does not overlap them (a lane stack of the memory image is read
    in place); anything else is copied first."""
    if tuple(t.shape) != tuple(shape):
        t = t.reshape(shape)
    per = 1
    for d in shape[1:]:
        per *= d
    lanes = shape[0]
    if not (t[0].is_contiguous() if lanes else True) or (
            lanes > 1 and t.stride(0) < per):
        t = t.contiguous()
    return t, (t.stride(0) if lanes > 1 else per)


def gemm_check(a: torch.Tensor, b: torch.Tensor, out_dtype,
               n_epilogue: int = 0, compensated: bool = False) -> None:
    """Raise ``ValueError`` for a product the kernel refuses: operands not
    both fp32 or both bf16, another output dtype, shapes that do not
    chain, too many epilogue stages, compensated lanes."""
    if a.dtype != b.dtype or a.dtype not in _GEMM_DTYPES:
        raise ValueError(f"ntx_gemm takes two fp32 or two bf16 operands, "
                         f"got {a.dtype} @ {b.dtype}")
    if out_dtype not in _GEMM_DTYPES:
        raise ValueError(f"ntx_gemm writes fp32 or bf16, not {out_dtype}")
    lanes3 = a.dim() == 3
    if (a.dim() not in (2, 3) or b.dim() != a.dim()
            or a.shape[-1] != b.shape[-2]
            or (lanes3 and a.shape[0] != b.shape[0])):
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if n_epilogue > MAX_EPILOGUE:
        raise ValueError(f"{n_epilogue} epilogue stages > {MAX_EPILOGUE}")
    if compensated and lanes3 and a.shape[0] > 1:
        raise ValueError("the compensated GEMM takes one lane")


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32,
              epilogue=(), compensated: bool = False,
              splits: int | None = None, tile: int | None = None
              ) -> torch.Tensor:
    """Launch ``csrc/ntx_gemm.cu``: a (m, k) @ b (k, n), both fp32 or both
    bf16, output fp32 or bf16. bf16 without ``compensated`` takes the
    tensor-core route, cut by :func:`split_k_plan` (a second launch adds
    the splits' partials); the rest the FFMA route. Array epilogue
    operands are read in their own dtype when fp32 or bf16 (others are
    cast to fp32), as (n,) for bias and (m, n) otherwise.
    ``compensated`` takes the kernel's Neumaier variant over
    KAHAN_SLAB-deep slabs.

    Lanes: a (L, m, k) @ b (L, k, n) is one launch of L independent
    products, with (L, n) / (L, m, n) epilogue operands, returning (L, m,
    n). Each lane's matrices must be contiguous; the lanes may sit at any
    stride (views of a memory image are read in place). Every lane takes
    the plan of one (m, n, k) product, so its bits equal a one-lane
    launch's. The compensated route takes one lane (more raise
    ``ValueError``).

    ``splits`` replaces the plan's number of k splits on the tensor-core
    route (to time the choice; the ``ops`` entry points never pass it).
    ``tile`` replaces :func:`ffma_plan`'s tile on the FFMA route, only to
    test that the kernel refuses it."""
    gemm_check(a, b, out_dtype, len(epilogue), compensated)
    lanes3 = a.dim() == 3
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if lanes3:
        lanes = a.shape[0]
        a, lda = _lane_operand(a, (lanes, m, k), "a")
        b, ldb = _lane_operand(b, (lanes, k, n), "b")
        c = torch.empty((lanes, m, n), dtype=out_dtype, device=a.device)
    else:                          # one product: no lane bookkeeping
        lanes, lda, ldb = 1, 0, 0
        a, b = a.contiguous(), b.contiguous()
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    operands, op_lane = [], []
    for kind, _, operand in epilogue:
        if kind in EPILOGUE_ARRAY_KINDS:
            want = (n,) if kind == "bias" else (m, n)
            if operand.dtype not in _GEMM_DTYPES:
                operand = operand.to(torch.float32)
            if lanes3:
                operand, ld = _lane_operand(operand, (lanes,) + want, kind)
                op_lane.append(ld)
            else:
                if operand.shape != want:
                    operand = operand.reshape(want)
                operand = operand.contiguous()
            operands.append(operand)
        else:
            operands.append(None)
            op_lane.append(0)
    kinds, imms, op_bf16 = _encode_epilogue(tuple(
        (kind, imm, None if op is None else op.dtype)
        for (kind, imm, _), op in zip(epilogue, operands)))
    ws = None
    if a.dtype == torch.bfloat16 and not compensated:
        plan = split_k_plan(m, n, k)
        tile, splits = plan.tile, splits or plan.splits
        if splits > 1:
            ws = torch.empty(lanes * splits * m * n, dtype=torch.float32,
                             device=a.device)
    elif splits not in (None, 1):
        raise ValueError("only the bf16 tensor-core route splits k")
    else:
        splits = 1
        tile = ffma_plan(m, n, k, bool(compensated),
                         a.dtype == torch.bfloat16).tile \
            if tile is None else tile
    ops_arr = _build.ptr_array(ctypes.c_void_p, [
        None if op is None else op.data_ptr() for op in operands])
    lane_arr = (_build.ptr_array(ctypes.c_longlong, op_lane) if lanes3
                else None)
    with _build.on_device(a):
        code = _build.library().ntx_gemm(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, lanes, lda,
            ldb, int(a.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(compensated),
            len(epilogue), kinds, imms, ops_arr, op_bf16, lane_arr, tile,
            splits, ws.data_ptr() if ws is not None else None,
            _build.stream_of(a))
    _build.check(code, "ntx_gemm")
    return c

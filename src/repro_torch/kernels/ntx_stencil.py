"""NTX star-stencil pass (paper §III-B3): the plain version and the
launcher of ``csrc/ntx_stencil.cu``.

Counterpart of ``repro.kernels.ntx_stencil``: a valid 1-D multi-tap
stencil, the taps in order over an fp32 accumulator. Star stencils
decompose into one such pass per axis. The Pallas kernel runs along the
last axis of (rows, n), so its wrapper moves the axis last, which copies
for every axis but the last; the CUDA kernel takes a contiguous
``(outer, n, inner)`` block and runs along n, so ``ops.stencil_axis``
hands it any axis of a contiguous array as a view.
"""
from __future__ import annotations

import math

import torch

from . import _build, ref

_X_DTYPES = (torch.float32, torch.bfloat16)


def stencil1d_plain(x: torch.Tensor, coeffs, axis: int = -1) -> torch.Tensor:
    """Plain version of ``_stencil_kernel`` along ``axis``: the taps in
    order over fp32 (``x`` widened first), each product rounded before its
    add (``ref.stencil_axis``). ``coeffs``: a sequence of floats, rounded
    to fp32 as the kernel's SMEM taps are."""
    return ref.stencil_axis(x.float(), coeffs, axis)


def as_blocks(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The contiguous ``x`` viewed as (outer, n, inner) around ``axis``."""
    axis = axis % x.dim()
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    return x.view(outer, x.shape[axis], inner)


def stencil1d_cuda(x3: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ntx_stencil.cu`` along the middle axis of a
    contiguous (outer, n, inner) fp32 or bf16 block; ``coeffs`` (k,) fp32
    on the same device. Returns (outer, n - k + 1, inner) fp32."""
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(f"ntx_stencil takes a contiguous (outer, n, inner) "
                         f"block, got {tuple(x3.shape)} strides "
                         f"{x3.stride()}")
    if x3.dtype not in _X_DTYPES:
        raise ValueError(f"ntx_stencil reads fp32 or bf16, not {x3.dtype}")
    if coeffs.dtype != torch.float32 or coeffs.dim() != 1:
        raise ValueError("ntx_stencil takes a (k,) fp32 tap vector")
    outer, n, inner = x3.shape
    k = coeffs.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"{k} taps do not fit an axis of {n}")
    coeffs = coeffs.contiguous()
    out = torch.empty((outer, n - k + 1, inner), dtype=torch.float32,
                      device=x3.device)
    lib = _build.library()
    with torch.cuda.device(x3.device):
        code = lib.ntx_stencil(x3.data_ptr(), coeffs.data_ptr(),
                               out.data_ptr(), outer, n, inner, k,
                               int(x3.dtype == torch.bfloat16),
                               _build.stream_of(x3))
    _build.check(code, "ntx_stencil")
    return out

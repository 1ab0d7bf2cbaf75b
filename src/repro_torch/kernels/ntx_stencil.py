"""NTX star stencils (paper §III-B3): the per-axis pass and the fused
Laplace, their plain versions and the launchers of ``csrc/ntx_stencil.cu``.

Counterpart of ``repro.kernels.ntx_stencil``: a valid 1-D multi-tap
stencil, the taps in order over an fp32 accumulator. Star stencils
decompose into one such pass per axis. The Pallas kernel runs along the
last axis of (rows, n), so its wrapper moves the axis last, which copies
for every axis but the last; the CUDA kernel takes a contiguous
``(outer, n, inner)`` block and runs along n, so ``ops.stencil_axis``
hands it any axis of a contiguous array as a view.

The Laplace is the reference's per-axis route (``repro.kernels.ops.
laplace``): one [1, -2, 1] pass per axis over the slice that is interior
on the other axes, the terms summed in axis order. ``laplace_plain`` runs
exactly that; the kernel ``ntx_laplace`` computes the same terms and the
same sums for a 1-D, 2-D or 3-D array in one launch.
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


LAPLACE_TAPS = (1.0, -2.0, 1.0)


def laplace_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the Laplace: per axis d, ``stencil1d_plain`` of
    the [1, -2, 1] taps over the slice interior on the other axes, the
    terms added in axis order (fp32 out; an axis shorter than 3 gives an
    empty result)."""
    nd, out = x.dim(), None
    for d in range(nd):
        sl = [slice(1, -1)] * nd
        sl[d] = slice(None)
        term = stencil1d_plain(x[tuple(sl)], LAPLACE_TAPS, d)
        out = term if out is None else out + term
    return out


def laplace_shape(shape) -> tuple:
    """The interior's shape (empty along an axis shorter than 3)."""
    return tuple(max(n - 2, 0) for n in shape)


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
    with _build.on_device(x3):
        code = lib.ntx_stencil(x3.data_ptr(), coeffs.data_ptr(),
                               out.data_ptr(), outer, n, inner, k,
                               int(x3.dtype == torch.bfloat16),
                               _build.stream_of(x3))
    _build.check(code, "ntx_stencil")
    return out


def laplace_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``ntx_laplace`` on a contiguous 1-D, 2-D or 3-D fp32 or
    bf16 array: its interior Laplace, fp32, in one launch (none when an
    axis is shorter than 3 and the interior is empty)."""
    if not 1 <= x.dim() <= 3 or not x.is_contiguous():
        raise ValueError(f"ntx_laplace takes a contiguous 1-D, 2-D or 3-D "
                         f"array, got {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"ntx_laplace reads fp32 or bf16, not {x.dtype}")
    out = torch.empty(laplace_shape(x.shape), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    n = (*x.shape, 1, 1)
    with _build.on_device(x):
        code = _build.library().ntx_laplace(
            x.data_ptr(), out.data_ptr(), x.dim(), n[0], n[1], n[2],
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "ntx_laplace")
    return out

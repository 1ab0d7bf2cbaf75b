"""NTX direct 2-D convolution (paper §III-B2): the plain version and the
launcher of ``csrc/ntx_conv.cu``.

Counterpart of ``repro.kernels.ntx_conv``: the valid correlation of one
(h, w) plane with (kh, kw) taps, the taps run i outer, j inner over an
fp32 accumulator (the PCS register), rounded once at the store. The
Pallas kernel takes one halo-overlapped strip per call and the host cuts
the strips; the CUDA kernel covers the whole plane in one launch, its
grid of output tiles taking the place of the host's strip loop.
"""
from __future__ import annotations

import torch

from . import _build, ref

_IMG_DTYPES = (torch.float32, torch.bfloat16)


def conv2d_plain(img: torch.Tensor, ker: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_conv_kernel``: ``acc = acc + ker[i, j] *
    img[i:i+oh, j:j+ow]``, i outer, j inner, in fp32, each product rounded
    before its add (``ref.conv2d``). img (h, w) any float dtype."""
    return ref.conv2d(img, ker)


def check_shapes(img: torch.Tensor, ker: torch.Tensor) -> None:
    if img.dim() != 2 or ker.dim() != 2:
        raise ValueError(f"conv2d takes an (h, w) plane and (kh, kw) taps, "
                         f"got {tuple(img.shape)} and {tuple(ker.shape)}")
    if not (1 <= ker.shape[0] <= img.shape[0]
            and 1 <= ker.shape[1] <= img.shape[1]):
        raise ValueError(f"taps {tuple(ker.shape)} do not fit the plane "
                         f"{tuple(img.shape)}")


def conv2d_cuda(img: torch.Tensor, ker: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ntx_conv.cu``: img (h, w) fp32 or bf16 (widened on
    load), ker (kh, kw) taps (taken as fp32), out (h-kh+1, w-kw+1) fp32."""
    check_shapes(img, ker)
    if img.dtype not in _IMG_DTYPES:
        raise ValueError(f"ntx_conv reads fp32 or bf16 planes, not "
                         f"{img.dtype}")
    h, w = img.shape
    kh, kw = ker.shape
    img = img.contiguous()
    ker = ker.to(torch.float32).contiguous()
    out = torch.empty((h - kh + 1, w - kw + 1), dtype=torch.float32,
                      device=img.device)
    lib = _build.library()
    with torch.cuda.device(img.device):
        code = lib.ntx_conv2d(img.data_ptr(), ker.data_ptr(), out.data_ptr(),
                              h, w, kh, kw, int(img.dtype == torch.bfloat16),
                              _build.stream_of(img))
    _build.check(code, "ntx_conv2d")
    return out

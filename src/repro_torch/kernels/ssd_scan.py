"""Mamba-2 SSD chunked scan: the plain version and the launcher of
``csrc/ssd_scan.cu``.

Counterpart of ``repro.kernels.ssd_scan``: the chunk loop carries the
(d_state, d_head) fp32 state S, the NTX wide accumulator, from chunk to
chunk; each chunk adds its intra-chunk masked decay-weighted ``C.B^T``
part and the carried-state part, then updates S. Unlike the Pallas
kernel both versions take the model's layouts (B and C once per batch
index, not copied per head) and any sequence length: the kernel masks a
short last chunk, the plain version pads it.
"""
from __future__ import annotations

import torch

from . import _build, ref

#: limits of the CUDA kernel (one lane per 32 steps or columns)
MAX_CHUNK = 128
MAX_HEAD_DIM = 128
#: shared memory one block may use on the H100
MAX_SMEM = 232448
_SLAB = 16


def smem_bytes(n: int, dh: int, chunk: int) -> int:
    """Shared memory of one block of ``csrc/ssd_scan.cu``."""
    return 4 * (chunk * (n + 1) + chunk * dh + n * dh + _SLAB * n
                + _SLAB * chunk + 2 * chunk)


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 64) -> torch.Tensor:
    """Plain version of what ``_ssd_kernel`` computes, in fp32 throughout:
    the masked chunked form ``ref.ssd_scan_chunked`` (all chunks at once,
    the state carried from chunk to chunk, the decay exponent masked to
    -inf above the diagonal before ``exp``). A ragged tail is padded with
    dt = 0 and x = 0, which adds nothing to the earlier steps (the scan
    is causal), and cut off again. ``ops.ssd``'s backward is autograd of
    this function.

    x: (b, l, h, dh); dt: (b, l, h); A: (h,); B/C: (b, l, n). Returns y
    (b, l, h, dh) in ``x.dtype``."""
    l = x.shape[1]
    if l == 0:
        return torch.empty_like(x)
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    pad = -l % chunk
    if pad:
        F = torch.nn.functional
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = F.pad(Bf, (0, 0, 0, pad)), F.pad(Cf, (0, 0, 0, pad))
    y = ref.ssd_scan_chunked(xf, dtf, Af, Bf, Cf, chunk=chunk)
    return y[:, :l].to(x.dtype)


def ssd_scan_cuda(x, dt, A, B, C, chunk: int = 64) -> torch.Tensor:
    """Launch ``csrc/ssd_scan.cu``. x: (b, l, h, dh) fp32 or bf16; B/C
    (b, l, n) in x's dtype; dt (b, l, h) and A (h,) fp32."""
    b, l, h, dh = x.shape
    n = B.shape[-1]
    if tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,) or \
            tuple(B.shape) != (b, l, n) or tuple(C.shape) != (b, l, n):
        raise ValueError(f"ssd shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            B.dtype == C.dtype == x.dtype):
        raise ValueError(f"ssd takes x, B, C all fp32 or all bf16, got "
                         f"{x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd takes fp32 dt and A, got {dt.dtype}/{A.dtype}")
    if not 1 <= chunk <= MAX_CHUNK or dh > MAX_HEAD_DIM or \
            smem_bytes(n, dh, chunk) > MAX_SMEM:
        raise ValueError(f"ssd kernel takes chunk <= {MAX_CHUNK}, head dim "
                         f"<= {MAX_HEAD_DIM} and {MAX_SMEM} bytes of shared "
                         f"memory; got chunk {chunk}, dh {dh}, n {n}")
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    B, C = B.contiguous(), C.contiguous()
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.ntx_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), b, l, h, dh, n, chunk,
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "ntx_ssd_scan")
    return y

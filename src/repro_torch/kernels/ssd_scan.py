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

from dataclasses import dataclass

import torch

from . import _build, ref

#: limits of the CUDA kernel (``kMaxChunk``, ``kMaxHeads``, ``kPad`` and
#: ``kThreads`` in ``csrc/ssd_scan.cu``): one 16-row strip of a chunk per
#: warp, 4 steps of the log-decay scan per lane
MAX_CHUNK = 128
MAX_HEAD_DIM = 128
MAX_HEADS = 64
PAD = 8
THREADS = 256
#: shared memory one block may use on the H100
MAX_SMEM = 232448
#: heads whose output blocks share one C B^T
HEADS_PER_BLOCK = 8
#: head-dim tiles the kernel is built for, per route (bf16: tensor cores,
#: 8-column mma tiles in pairs; fp32: 32 columns a thread)
D_TILES = {True: (16, 32, 64, 128), False: (32, 64, 128)}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class SSDPlan:
    """How ``csrc/ssd_scan.cu`` cuts one call: the chunk padded to ``lp``
    rows and d_state to ``np`` (zero-filled), ``dtile`` head-dim columns
    and ``heads`` heads per block of passes 1 and 3, whose grid is
    ``(nc, b, head_groups * d_tiles)``; pass 2 is a grid of
    ``(ceil(n * dh / 256), h, b)``. Three launches per call."""
    bf16: bool
    chunk: int
    lp: int
    np: int
    dtile: int
    heads: int
    nc: int
    head_groups: int
    d_tiles: int
    smem_state: int
    smem_out: int

    def blocks(self, b: int) -> int:
        """Blocks of pass 1 (and of pass 3)."""
        return self.nc * b * self.head_groups * self.d_tiles


def smem_bytes(bf16: bool, lp: int, np: int, dtile: int,
               heads: int) -> tuple:
    """Shared memory of one block of pass 1 and of pass 3, as
    ``state_smem`` and ``out_smem`` in ``csrc/ssd_scan.cu`` count it.
    bf16: B (pass 1) or C and B (pass 3) as exact bf16 rows padded by
    ``PAD``; the three bf16 planes of exp(la_L - la_s) dt_s x_s (pass 1)
    or of S (pass 3, over B); x; the log-decay and dt of each head. fp32:
    B and exp(la_L - la_s) dt_s x_s (pass 1); C^T, G^T and dt x with S
    (over B^T) (pass 3)."""
    if bf16:
        state = 2 * lp * (np + PAD) + 6 * lp * (dtile + PAD)
        cs = 2 * lp * (np + PAD)
        out = cs + 2 * lp * (dtile + PAD) + max(6 * np * (dtile + PAD), cs)
    else:
        state = 4 * lp * np + 4 * lp * dtile
        ct = 4 * np * (lp + 4)
        out = ct + 4 * lp * lp + max(4 * (lp + np) * dtile, ct)
    extra = 8 * heads * lp
    return state + extra, out + extra


def scan_plan(b: int, l: int, h: int, dh: int, n: int, chunk: int,
              bf16: bool = True) -> SSDPlan:
    """The kernel's plan for x (b, l, h, dh), B/C (b, l, n): up to
    ``HEADS_PER_BLOCK`` heads per block (C B^T is formed once for them),
    the smallest head-dim tile that covers dh, halved until both passes
    fit ``MAX_SMEM``. Raises for what the kernel cannot run."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd kernel takes 1 <= chunk <= {MAX_CHUNK}, got "
                         f"{chunk}")
    if not 1 <= dh <= MAX_HEAD_DIM or n < 1:
        raise ValueError(f"ssd kernel takes 1 <= head dim <= {MAX_HEAD_DIM} "
                         f"and d_state >= 1, got {dh} and {n}")
    if min(b, l, h) < 0:
        raise ValueError(f"negative extent in b {b}, l {l}, h {h}")
    lp = _round_up(chunk, 16 if bf16 else 32)
    np_ = _round_up(n, 16)
    heads = max(1, min(HEADS_PER_BLOCK, h))
    tiles = D_TILES[bf16]
    dtile = next((t for t in tiles if t >= dh), tiles[-1])
    while max(smem_bytes(bf16, lp, np_, dtile, heads)) > MAX_SMEM and \
            dtile > tiles[0]:
        dtile //= 2
    state, out = smem_bytes(bf16, lp, np_, dtile, heads)
    if max(state, out) > MAX_SMEM:
        raise ValueError(f"ssd kernel: chunk {chunk}, d_state {n} need "
                         f"{max(state, out)} bytes of shared memory > "
                         f"{MAX_SMEM}")
    return SSDPlan(bf16=bf16, chunk=chunk, lp=lp, np=np_, dtile=dtile,
                   heads=heads, nc=-(-l // chunk) if l else 0,
                   head_groups=-(-h // heads) if h else 0,
                   d_tiles=-(-dh // dtile), smem_state=state, smem_out=out)


def _padded_f32(x, dt, A, B, C, chunk: int):
    """The operands in fp32, a ragged tail padded with dt = 0 and x = 0
    (B and C with 0): a padded step decays by exp(0) = 1 and adds 0, so
    it changes neither the earlier outputs (the scan is causal) nor the
    state."""
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    pad = -x.shape[1] % chunk
    if pad:
        F = torch.nn.functional
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = F.pad(Bf, (0, 0, 0, pad)), F.pad(Cf, (0, 0, 0, pad))
    return xf, dtf, Af, Bf, Cf


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 64) -> torch.Tensor:
    """Plain version of what ``_ssd_kernel`` computes, in fp32 throughout:
    the masked chunked form ``ref.ssd_scan_chunked`` (all chunks at once,
    the state carried from chunk to chunk, the decay exponent masked to
    -inf above the diagonal before ``exp``). A ragged tail is padded with
    dt = 0 and x = 0 and cut off again. ``ops.ssd``'s backward is
    autograd of this function.

    x: (b, l, h, dh); dt: (b, l, h); A: (h,); B/C: (b, l, n). Returns y
    (b, l, h, dh) in ``x.dtype``."""
    l = x.shape[1]
    if l == 0:
        return torch.empty_like(x)
    y = ref.ssd_scan_chunked(*_padded_f32(x, dt, A, B, C, chunk),
                             chunk=chunk)
    return y[:, :l].to(x.dtype)


def ssd_scan_with_state_plain(x, dt, A, B, C, chunk: int = 64):
    """Plain version of the kernel with its final-state output: the
    masked chunked form on the padded length
    (``ref.ssd_scan_chunked_with_state``), returning y (b, l, h, dh) in
    ``x.dtype`` and the state after the last real step, (b, h, n, dh)
    fp32 (zeros for l = 0)."""
    b, l, h, dh = x.shape
    if l == 0:
        return torch.empty_like(x), torch.zeros(
            b, h, B.shape[-1], dh, dtype=torch.float32, device=x.device)
    y, s = ref.ssd_scan_chunked_with_state(
        *_padded_f32(x, dt, A, B, C, chunk), chunk=chunk)
    return y[:, :l].to(x.dtype), s


def ssd_scan_cuda(x, dt, A, B, C, chunk: int = 64,
                  plan: SSDPlan | None = None, final_state: bool = False):
    """Launch ``csrc/ssd_scan.cu`` (three kernels). x: (b, l, h, dh) fp32
    or bf16; B/C (b, l, n) in x's dtype; dt (b, l, h) and A (h,) fp32.
    Returns y, or with ``final_state`` (y, the state after the last step,
    (b, h, n, dh) fp32), which the carry pass stores as it ends; y is the
    same either way. ``plan`` defaults to :func:`scan_plan`; another plan
    is passed only to test that the kernel refuses it, the ``ops`` entry
    point never does."""
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
    bf16 = x.dtype == torch.bfloat16
    p = plan or scan_plan(b, l, h, dh, n, chunk, bf16)
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    B, C = B.contiguous(), C.contiguous()
    y = torch.empty_like(x)
    nc = -(-l // chunk)
    # the states: each chunk's own contribution, then (in place) the
    # state entering each chunk; and exp(la_L) per chunk and head
    S = torch.empty((b, nc, h, n, dh), dtype=torch.float32, device=x.device)
    dec = torch.empty((b, nc, h), dtype=torch.float32, device=x.device)
    # the kernel writes no state for l = 0: the state is then zero
    s_final = ((torch.empty if l else torch.zeros)(
        (b, h, n, dh), dtype=torch.float32, device=x.device)
        if final_state else None)
    with _build.on_device(x):
        code = _build.library().ntx_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), S.data_ptr(), dec.data_ptr(),
            None if s_final is None else s_final.data_ptr(), b, l, h, dh, n,
            chunk, int(bf16), p.lp, p.np, p.dtile, p.heads,
            _build.stream_of(x))
    _build.check(code, "ntx_ssd_scan")
    return y if s_final is None else (y, s_final)

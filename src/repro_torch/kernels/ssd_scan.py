"""Mamba-2 SSD chunked scan: the plain versions and the launchers of
``csrc/ssd_scan.cu`` (the scan) and ``csrc/ssd_scan_bwd.cu`` (its
backward).

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

#: limits of the CUDA kernels (``kMaxChunk``, ``kMaxHeads``, ``kPad`` and
#: ``kThreads`` in ``csrc/ssd_scan.cuh``; ``kMaxHeadDim`` in
#: ``csrc/ssd_scan_bwd.cu``): one 16-row strip of a chunk per warp, 4
#: steps of the log-decay scan per lane
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
    :func:`ssd_scan_bwd_plain` (CPU) or :func:`ssd_scan_bwd_cuda`; autograd
    of this function is the tests' oracle for both.

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


def _log_decay(a):
    """The inclusive cumsum of a = dt A over dim 2 (a chunk's steps) in the
    order ``chunk_log_decay`` in ``csrc/ssd_scan.cuh`` adds it, so that
    the backward's plain version and its kernel see the same log-decay
    bits (at |la| in the thousands an fp32 ulp of la moves every exp of
    it): 32 lanes of 4 consecutive steps each (more for a chunk above
    128), summed in turn inside a lane, then a Hillis-Steele scan of the
    lanes' sums, each lane's exclusive prefix added to its steps."""
    F = torch.nn.functional
    a = a.movedim(2, -1)
    L = a.shape[-1]
    per = max(4, -(-L // 32))
    a = F.pad(a, (0, 32 * per - L)).unflatten(-1, (32, per))
    q = [a[..., 0]]
    for i in range(1, per):
        q.append(q[-1] + a[..., i])
    incl = q[-1]
    lane = torch.arange(32, device=a.device)
    for o in (1, 2, 4, 8, 16):
        incl = torch.where(lane >= o, incl + F.pad(incl, (o, 0))[..., :32],
                           incl)
    excl = F.pad(incl, (1, 0))[..., :32]
    la = torch.stack([excl + qi for qi in q], -1).flatten(-2)[..., :L]
    return la.movedim(-1, 2)


def _reverse_carry(local, la_last):
    """R_c, the gradient of the state leaving chunk c: 0 after the last
    chunk, R_{c-1} = local_c + exp(la_L,c) R_c (the forward's carry run
    backward over the chunks)."""
    r = torch.zeros_like(local[:, 0])
    out = [r] * local.shape[1]
    for c in reversed(range(local.shape[1])):
        out[c] = r
        r = torch.exp(la_last[:, c])[..., None, None] * r + local[:, c]
    return torch.stack(out, 1)


def ssd_scan_bwd_plain(x, dt, A, B, C, gy, chunk: int = 64):
    """Plain version of ``csrc/ssd_scan_bwd.cu``: the gradients of
    :func:`ssd_scan_plain`'s y for the upstream gradient gy, in closed
    form and in the kernel's passes, in fp32 with every decay exponent
    masked before ``exp``. Per (batch, head) and chunk of L steps, la is
    the inclusive cumsum of dt A (added in the kernel's order,
    :func:`_log_decay`), u_s = dt_s x_s, S_c the state entering
    chunk c and R_c the gradient of the state leaving it:

    (a) S_c, carried as the forward carries it;
    (b) each chunk's own sum_t exp(la_t) C_t (x) gy_t;
    (c) the reverse carry R_{c-1} = (b)_c + exp(la_L) R_c, R 0 after the
        last chunk (``ops.ssd`` returns y only);
    (d) per chunk, with M_ts = exp(la_t - la_s) (C_t . B_s) for s <= t:
        du = M^T gy + diag(exp(la_L - la_s)) B R_c, dx = dt du;
        dC_t = sum_{s<=t} exp(la_t - la_s) (gy_t . u_s) B_s
               + exp(la_t) S_c gy_t;
        dB_s = sum_{t>=s} exp(la_t - la_s) (gy_t . u_s) C_t
               + exp(la_L - la_s) R_c u_s;
        d la from every exponent (the state update's la_L too; P_tt,
        which enters and leaves la_t, left out), summed backward inside
        the chunk into d(dt A): A d(dt A) joins x . du in d dt, and
        dt d(dt A) summed gives dA;
    (e) dB and dC summed over heads, dA over batch and steps.

    A ragged tail is padded as the forward pads it and cut off again.
    Returns (dx, ddt, dA, dB, dC): dx, dB, dC in x's dtype, ddt and dA
    fp32, as autograd of :func:`ssd_scan_plain` returns them."""
    b, l, h, dh = x.shape
    n = B.shape[-1]
    if l == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(B), torch.zeros_like(C))
    xf, dtf, Af, Bf, Cf = _padded_f32(x, dt, A, B, C, chunk)
    gyf = torch.nn.functional.pad(gy.float(), (0, 0, 0, 0, 0, -l % chunk))
    lpad = xf.shape[1]
    nc, L = lpad // chunk, chunk
    xc = xf.view(b, nc, L, h, dh)
    gyc = gyf.view(b, nc, L, h, dh)
    dtc = dtf.view(b, nc, L, h)
    Bc, Cc = Bf.view(b, nc, L, n), Cf.view(b, nc, L, n)
    la = _log_decay(dtc * Af)                                # (b,nc,L,h)
    la_last = la[:, :, -1]                                   # (b,nc,h)
    u = dtc[..., None] * xc
    w_last = torch.exp(la_last[:, :, None] - la)             # exp(la_L-la_s)
    e_la = torch.exp(la)
    # (a) - (c)
    S, _ = ref._carry(torch.einsum("bcsn,bcsh,bcshd->bchnd", Bc, w_last, u),
                      la_last)
    R = _reverse_carry(torch.einsum("bctn,bcth,bcthd->bchnd", Cc, e_la,
                                    gyc), la_last)
    # (d): (b, nc, t, s, h) pairs, masked before exp
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]
    dec = torch.exp(torch.where(tri[:, :, None], diff, float("-inf")))
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None]
    Pp = dec * torch.einsum("bcthd,bcshd->bctsh", gyc, u)    # P'_ts
    du_c = w_last[..., None] * torch.einsum("bcsn,bchnd->bcshd", Bc, R)
    du = torch.einsum("bctsh,bcthd->bcshd", dec * G, gyc) + du_c
    dC_c = torch.einsum("bcth,bcthd,bchnd->bcthn", e_la, gyc, S)
    dC = torch.einsum("bctsh,bcsn->bctn", Pp, Bc) + dC_c.sum(3)
    dB = torch.einsum("bctsh,bctn->bcsn", Pp, Cc) + torch.einsum(
        "bcsh,bcshd,bchnd->bcsn", w_last, u, R)
    # d la: P_ts = G_ts P'_ts enters la_t and leaves la_s (s < t: P_tt
    # would enter and leave la_t, and only add rounding); the carried part
    # (Q) enters la_t; the state update's terms (V) leave la_s and enter
    # la_L, as does exp(la_L) <R_c, S_c>. Summed in fp64, as the kernel
    # sums them: d(dt A) takes differences of sums whose terms can be far
    # larger than it
    eye = torch.eye(L, dtype=torch.bool, device=x.device)[:, :, None]
    P = (Pp * G).masked_fill(eye, 0.0).double()
    Q = (Cc[:, :, :, None, :] * dC_c).sum(-1).double()
    V = (du_c * u).sum(-1).double()
    dla = P.sum(3) - P.sum(2) + Q - V
    dla[:, :, -1] += V.sum(2) + torch.exp(la_last).double() * (
        R * S).sum((-2, -1)).double()
    da = torch.flip(torch.cumsum(torch.flip(dla, [2]), 2), [2])
    ddt = ((xc * du).sum(-1) + Af.double() * da).float()
    dA = (dtc.double() * da).sum((0, 1, 2)).float()
    dx = dtc[..., None] * du

    def cut(t, dtype):
        return t.reshape(b, lpad, *t.shape[3:])[:, :l].to(dtype)
    return (cut(dx, x.dtype), cut(ddt, torch.float32), dA,
            cut(dB, x.dtype), cut(dC, x.dtype))


def ssd_check(x, dt, A, B, C) -> None:
    """Raise ``ValueError`` for operands the kernel refuses: shapes that
    do not match x (b, l, h, dh), x / B / C not all fp32 or all bf16, dt
    or A not fp32."""
    b, l, h, _ = x.shape
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


def ssd_bwd_check(x, dt, A, B, C, gy) -> None:
    """:func:`ssd_check`, and gy of x's shape and dtype."""
    ssd_check(x, dt, A, B, C)
    if tuple(gy.shape) != tuple(x.shape) or gy.dtype != x.dtype:
        raise ValueError(f"ssd backward takes gy of x's shape and dtype "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(gy.shape)} {gy.dtype}")


def ssd_flops(b: int, l: int, h: int, dh: int, n: int, chunk: int) -> int:
    """The scan's operations on this data: per chunk of L steps, C B^T
    and W X over the s <= t pairs, L (L + 1) (n + dh), plus C S and the
    state update, 4 L n dh; for every (batch, head)."""
    def per_chunk(L):
        return L * (L + 1) * (n + dh) + 4 * L * n * dh
    full, rest = divmod(l, chunk)
    return b * h * (full * per_chunk(chunk) + (per_chunk(rest) if rest
                                               else 0))


def ssd_bwd_flops(b: int, l: int, h: int, dh: int, n: int,
                  chunk: int) -> int:
    """The backward's operations on this data, in :func:`ssd_flops`'s
    manner: per chunk of L steps, over the s <= t pairs, C B^T, gy . u,
    the intra-chunk dB and dC products (n each) and M^T gy (dh),
    L (L + 1) (3 n + 2 dh); the recomputed state update, the reverse
    carry's own sum, B R, gy S^T and u R^T, 10 L n dh; for every (batch,
    head)."""
    def per_chunk(L):
        return L * (L + 1) * (3 * n + 2 * dh) + 10 * L * n * dh
    full, rest = divmod(l, chunk)
    return b * h * (full * per_chunk(chunk) + (per_chunk(rest) if rest
                                               else 0))


@dataclass(frozen=True)
class SSDBwdPlan:
    """How ``csrc/ssd_scan_bwd.cu`` cuts one backward call. Passes (a)
    and (b) run the forward's state pass (and (a) its carry) at ``fwd``,
    the forward's plan;
    the gradient pass (d) takes a chunk padded to ``lp`` rows (16-row warp
    strips), the head dim padded to ``dp``, d_state ``nb`` columns at a
    time (``n_tiles`` stagings, zero-filled past n) and ``heads`` heads a
    block, over a grid of ``(nc, b, head_groups)`` with ``smem`` bytes of
    shared memory."""
    fwd: SSDPlan
    lp: int
    dp: int
    nb: int
    heads: int
    n_tiles: int
    head_groups: int
    smem: int


def grad_smem(bf16: bool, lp: int, dp: int, nb: int, heads: int) -> int:
    """Shared memory of one block of the gradient pass, as ``grad_smem``
    in ``csrc/ssd_scan_bwd.cu`` counts it: C and B (``nb`` columns) and x
    and gy (``dp`` columns), rows padded by ``PAD`` elements, bf16 as they
    are or fp32; R and S (``nb`` x ``dp`` each) as three exact bf16 planes
    or fp32; two fp64 sums a step; dt and the log-decay of each head,
    three fp32 sums a step and a reduction's 16 floats."""
    e = 2 if bf16 else 4
    tiles = e * (2 * lp * (nb + PAD) + 2 * lp * (dp + PAD))
    states = 2 * nb * (dp + PAD) * (6 if bf16 else 4)
    return tiles + states + 16 * lp + 4 * (2 * heads * lp + 3 * lp + 16)


def ssd_bwd_plan(b: int, l: int, h: int, dh: int, n: int, chunk: int,
                 bf16: bool = True) -> SSDBwdPlan:
    """The backward kernel's plan: the forward's plan for the states, and
    for the gradient pass the widest d_state staging (all of it, then
    halved in 16-column steps) that fits ``MAX_SMEM``. Raises
    ``ValueError`` for what the kernel cannot run."""
    fwd = scan_plan(b, l, h, dh, n, chunk, bf16)
    lp, dp, np_ = _round_up(chunk, 16), _round_up(dh, 16), fwd.np
    heads = max(1, min(HEADS_PER_BLOCK, h))
    nb = np_
    while grad_smem(bf16, lp, dp, nb, heads) > MAX_SMEM and nb > 16:
        nb = max(16, _round_up(nb // 2, 16))
    smem = grad_smem(bf16, lp, dp, nb, heads)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd backward kernel: chunk {chunk}, head dim {dh}"
                         f" need {smem} bytes of shared memory > {MAX_SMEM}")
    return SSDBwdPlan(fwd=fwd, lp=lp, dp=dp, nb=nb, heads=heads,
                      n_tiles=-(-np_ // nb),
                      head_groups=-(-h // heads) if h else 0, smem=smem)


def ssd_scan_cuda(x, dt, A, B, C, chunk: int = 64,
                  plan: SSDPlan | None = None, final_state: bool = False):
    """Launch ``csrc/ssd_scan.cu`` (three kernels). x: (b, l, h, dh) fp32
    or bf16; B/C (b, l, n) in x's dtype; dt (b, l, h) and A (h,) fp32.
    Returns y, or with ``final_state`` (y, the state after the last step,
    (b, h, n, dh) fp32), which the carry pass stores as it ends; y is the
    same either way. ``plan`` defaults to :func:`scan_plan`; another plan
    is passed only to test that the kernel refuses it, the ``ops`` entry
    point never does."""
    ssd_check(x, dt, A, B, C)
    b, l, h, dh = x.shape
    n = B.shape[-1]
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


def ssd_scan_bwd_cuda(x, dt, A, B, C, gy, chunk: int = 64,
                      plan: SSDBwdPlan | None = None):
    """Launch ``csrc/ssd_scan_bwd.cu``: the gradients of the scan's y for
    the upstream gradient gy (x's shape and dtype), as
    :func:`ssd_scan_bwd_plain` returns them. ``plan`` defaults to
    :func:`ssd_bwd_plan`; another is passed only to test that the kernel
    refuses it."""
    ssd_bwd_check(x, dt, A, B, C, gy)
    b, l, h, dh = x.shape
    n = B.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    p = plan or ssd_bwd_plan(b, l, h, dh, n, chunk, bf16)
    x, dt, A, B, C, gy = (t.contiguous() for t in (x, dt, A, B, C, gy))
    nc = -(-l // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (x, dt, B, C))
    dA = torch.empty((h,), **f32)
    # scratch: the states entering each chunk and the gradients leaving
    # it, exp(la_L) a chunk, the per-head dB and dC and per-chunk dA (fp64)
    # partials that pass (e) sums in a fixed order
    S, R = (torch.empty((b, nc, h, n, dh), **f32) for _ in range(2))
    dec = torch.empty((b, nc, h), **f32)
    dAp = torch.empty((b, nc, h), dtype=torch.float64, device=x.device)
    dBp, dCp = (torch.empty((b, l, h, n), **f32) for _ in range(2))
    f = p.fwd
    with _build.on_device(x):
        code = _build.library().ntx_ssd_scan_bwd(
            *(t.data_ptr() for t in (x, dt, A, B, C, gy, dx, ddt, dA, dB,
                                     dC, S, R, dec, dBp, dCp, dAp)),
            b, l, h, dh, n, chunk, int(bf16), f.lp, f.np, f.dtile, f.heads,
            p.lp, p.dp, p.nb, p.heads, _build.stream_of(x))
    _build.check(code, "ntx_ssd_scan_bwd")
    return dx, ddt, dA, dB, dC

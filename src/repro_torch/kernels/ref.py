"""Plain PyTorch oracles for the kernels this package ports.

The counterpart of ``repro.kernels.ref``: GEMM and AXPY, the streaming
command set, the row reductions, the paper's convolution and star
stencils, reference attention and the blocked online-softmax attention
with its flash-style backward, the Mamba-2 SSD scan (sequential and
chunked) and AdamW.
Same math, no tiling; the CPU path of every ``ops`` wrapper and the
yardstick each CUDA kernel is compared with on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(v: float) -> float:
    """``v`` rounded to fp32 and returned as a Python float: the value an
    immediate has inside an fp32 datapath (JAX casts a weak-typed Python
    float the same way)."""
    return float(np.float32(v))


# ----------------------------------------------------------------------
# GEMM / BLAS
# ----------------------------------------------------------------------
def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B with fp32 accumulation, rounded once to ``out_dtype``.

    bf16 inputs widen exactly to fp32, so this is the same product the
    reference takes with ``preferred_element_type=float32``."""
    return (a.float() @ b.float()).to(out_dtype)


def axpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` as the reference writes it (no pinned rounding: the
    streaming command's AXPY is ``elementwise("axpy", ...)``)."""
    return a * x + y


def _rounded(v: torch.Tensor) -> torch.Tensor:
    """Pin a product's fp32 rounding (``repro.kernels.ref._rounded``).

    PyTorch's eager kernels never contract a multiply with a later add,
    so every product is already rounded on its own; the function is kept
    so the streaming ops read like the reference and so a future fused
    path has the one place to pin it. The CUDA kernel pins the same
    rounding with ``__fmul_rn``/``__fadd_rn``."""
    return v


def elementwise(op: str, x: torch.Tensor, y: torch.Tensor | None = None,
                imm: float = 0.0) -> torch.Tensor:
    imm = f32(imm)
    if op == "axpy":
        return _rounded(imm * x) + y
    if op == "add":
        return x + y
    if op == "sub":
        return x - y
    if op == "mul":
        return _rounded(x * y)
    if op == "relu":
        return torch.clamp_min(x, 0.0)
    if op == "thresh":
        return torch.where(x > imm, x, torch.zeros_like(x))
    if op == "mask":
        return torch.where(y != 0, x, torch.zeros_like(x))
    if op == "copy":
        return x
    if op == "set":
        return torch.full_like(x, imm)
    raise ValueError(op)


def reduce(op: str, x: torch.Tensor) -> torch.Tensor:
    """Reduce over the last axis. x: (rows, n). Arg ops return int32 and
    resolve ties to the first index, like ``np.argmax``. Each row is summed
    on its own: torch splits a lone long row across threads, so summing
    (rows, n) in one call could give a row other bits than summing it
    alone, and a lane-batched run must give each lane the bits of a
    one-lane run."""
    if op == "sum":
        rows = x.reshape(-1, x.shape[-1])
        if rows.shape[0] <= 1:
            return x.sum(-1)
        return torch.stack([r.sum() for r in rows]).reshape(x.shape[:-1])
    if op == "min":
        return x.amin(-1)
    if op == "max":
        return x.amax(-1)
    if op == "argmin":
        return torch.argmin(x, -1).to(torch.int32)
    if op == "argmax":
        return torch.argmax(x, -1).to(torch.int32)
    raise ValueError(op)


# ----------------------------------------------------------------------
# Convolution (paper §III-B2): valid 2-D, single channel plane
# ----------------------------------------------------------------------
def conv2d(img: torch.Tensor, ker: torch.Tensor) -> torch.Tensor:
    """Valid correlation of (H, W) with (kh, kw): the NTX conv command.

    Both are taken in fp32 (an fp32 0-d tap times a bf16 plane is fp32 in
    JAX but bf16 in PyTorch); the taps run i outer, j inner, each product
    rounded before its add, as ``repro.kernels.ref.conv2d``."""
    img, ker = img.float(), ker.float()
    kh, kw = ker.shape
    h, w = img.shape
    oh, ow = h - kh + 1, w - kw + 1
    out = torch.zeros((oh, ow), dtype=torch.float32, device=img.device)
    for i in range(kh):
        for j in range(kw):
            out = out + ker[i, j] * img[i:i + oh, j:j + ow]
    return out


# ----------------------------------------------------------------------
# Stencils (paper §III-B3)
# ----------------------------------------------------------------------
def stencil_axis(x: torch.Tensor, coeffs, axis: int) -> torch.Tensor:
    """1-D stencil along ``axis`` (valid region), len(coeffs) taps."""
    k = len(coeffs)
    n = x.shape[axis]
    out = None
    for i, c in enumerate(coeffs):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + n - k + 1)
        term = f32(c) * x[tuple(sl)]
        out = term if out is None else out + term
    return out


def laplace(x: torch.Tensor) -> torch.Tensor:
    """Discrete Laplace operator in ndim dims (3/5/7-point star stencil):
    interior(out) = sum_d (x[+1_d] + x[-1_d]) - 2 ndim x."""
    nd = x.ndim
    core = [slice(1, -1)] * nd
    out = torch.zeros(x[tuple(core)].shape, dtype=torch.float32,
                      device=x.device)
    for d in range(nd):
        sl_p = list(core)
        sl_m = list(core)
        sl_p[d] = slice(2, None)
        sl_m[d] = slice(0, -2)
        out = out + x[tuple(sl_p)] + x[tuple(sl_m)]
    return out - 2.0 * nd * x[tuple(core)]


def diffusion(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """The 13-coefficient 2nd-order diffusion stencil of Gysi et al.,
    decomposed as the paper describes (§III-B3) into a 9-point 3x3 kernel
    plus the two distance-2 axis taps: x + alpha * L2(x) on the valid
    interior."""
    k9 = torch.tensor([[1., 2., 1.], [2., -12., 2.], [1., 2., 1.]],
                      dtype=torch.float32, device=x.device)
    inner = conv2d(x, k9)
    core = x[2:-2, 2:-2]
    t_v = x[:-4, 2:-2] + x[4:, 2:-2]
    t_h = x[2:-2, :-4] + x[2:-2, 4:]
    return core + alpha * (inner[1:-1, 1:-1] + t_v + t_h)


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, scale: float | None = None,
        q_offset: int = 0) -> torch.Tensor:
    """Reference attention. q: (b, hq, sq, d); k/v: (b, hkv, skv, d).

    GQA: hq is a multiple of hkv, the grouped einsum never repeats K/V.
    ``q_offset`` positions the query block inside the kv sequence for
    causal masking (decode: q_offset = cache_len)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * f32(scale)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos), float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def _blocked(t: torch.Tensor, block_k: int) -> torch.Tensor:
    """(b, hkv, skv, d) as (nk, b, hkv, block_k, d) fp32 key blocks, the
    last one padded with zeros (its padded keys are masked)."""
    b, hkv, skv, d = t.shape
    nk = -(-skv // block_k)
    t = torch.nn.functional.pad(t.float(), (0, 0, 0, nk * block_k - skv))
    return t.reshape(b, hkv, nk, block_k, d).permute(2, 0, 1, 3, 4)


def _block_logits(qg, kc, ik, block_k, skv, causal, qpos, scale=None):
    """The logits of one key block (times ``scale`` if given), masked as
    the reference masks them (-1e30 above the causal diagonal); keys past
    the array (the ragged last block) are -inf, so they weigh 0."""
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc)
    if scale is not None:
        logits = logits * scale
    kpos = ik * block_k + torch.arange(block_k, device=qg.device)
    if causal:
        logits = torch.where(kpos[None, :] <= qpos[:, None], logits,
                             torch.full_like(logits, -1e30))
    return torch.where(kpos < skv, logits, torch.full_like(logits,
                                                          -float("inf")))


def mha_blocked_fwd(q, k, v, causal: bool = True, scale=None,
                    q_offset: int = 0, block_k: int = 512):
    """The forward of ``repro.kernels.ref.mha_blocked`` (its
    ``_mha_blocked_fwd``): a loop over key blocks carrying the running
    (max, sum, acc) in fp32. Any skv (a ragged last block is masked).
    Returns ``(out (b, hq, sq, dv) in q.dtype, lse (b, hq, sq) fp32)``,
    ``lse = m + log(max(l, 1e-30))`` of the scaled logits."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g, dv = hq // hkv, v.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, sq, d).float() * f32(scale)
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hkv, g, sq, 1), -1e30, device=q.device)
    l = torch.zeros((b, hkv, g, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), device=q.device)
    for ik, (kc, vc) in enumerate(zip(_blocked(k, block_k),
                                      _blocked(v, block_k))):
        logits = _block_logits(qg, kc, ik, block_k, skv, causal, qpos)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    out = (acc / torch.where(l == 0.0, torch.ones_like(l), l))
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    return (out.reshape(b, hq, sq, dv).to(q.dtype),
            lse.reshape(b, hq, sq))


def mha_blocked_bwd(q, k, v, out, lse, dout, causal: bool = True,
                    scale=None, q_offset: int = 0, block_k: int = 512):
    """The flash-style backward of ``repro.kernels.ref.mha_blocked`` (its
    ``_mha_blocked_bwd``): per key block, ``p = exp(logits - lse)`` is
    recomputed from the forward's ``lse``; ``D = rowsum(dO o O)``,
    ``dS = p (dP - D) scale``. All in fp32; returns ``(dq, dk, dv)`` in
    the inputs' dtypes. ``lse``: (b, hq, sq) fp32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g, dv = hq // hkv, v.shape[-1]
    scale = f32((d ** -0.5) if scale is None else scale)
    qg = q.reshape(b, hkv, g, sq, d).float()
    dog = dout.reshape(b, hkv, g, sq, dv).float()
    D = (dog * out.reshape(b, hkv, g, sq, dv).float()).sum(-1, keepdim=True)
    lse = lse.reshape(b, hkv, g, sq, 1).float()
    qpos = torch.arange(sq, device=q.device) + q_offset
    dq = torch.zeros((b, hkv, g, sq, d), device=q.device)
    dks, dvs = [], []
    for ik, (kc, vc) in enumerate(zip(_blocked(k, block_k),
                                      _blocked(v, block_k))):
        logits = _block_logits(qg, kc, ik, block_k, skv, causal, qpos,
                               scale)
        p = torch.exp(logits - lse)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vc)
        ds = p * (dp - D) * scale
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg))
    dk = torch.cat(dks, 2)[:, :, :skv] if dks else torch.zeros_like(
        k, dtype=torch.float32)
    dvv = torch.cat(dvs, 2)[:, :, :skv] if dvs else torch.zeros_like(
        v, dtype=torch.float32)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


class _MhaBlocked(torch.autograd.Function):
    """``mha_blocked`` with the reference's custom VJP: the backward
    recomputes ``p`` per key block from the saved ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, block_k):
        out, lse = mha_blocked_fwd(q, k, v, causal, scale, q_offset,
                                   block_k)
        ctx.args = (causal, scale, q_offset, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*mha_blocked_bwd(q, k, v, out, lse, dout, *ctx.args),
                None, None, None, None)


def mha_blocked(q, k, v, causal: bool = True, scale=None, q_offset: int = 0,
                block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over key blocks with a flash-style
    backward (``repro.kernels.ref.mha_blocked``). q: (b, hq, sq, d); k/v:
    (b, hkv, skv, d); any skv."""
    return _MhaBlocked.apply(q, k, v, causal, scale, q_offset, block_k)


# ----------------------------------------------------------------------
# Mamba-2 SSD
# ----------------------------------------------------------------------
def _ssd_sequential(x, dt, A, B, C):
    """The recurrence step by step in fp32: (y fp32, final state)."""
    b, l, h, dh = x.shape
    n = B.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    s = torch.zeros(b, h, n, dh, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * Af)                    # (b, h)
        upd = dtf[:, t, :, None] * xf[:, t]                  # (b, h, dh)
        s = decay[..., None, None] * s + \
            Bf[:, t, None, :, None] * upd[:, :, None, :]
        ys.append(torch.einsum("bn,bhnd->bhd", Cf[:, t], s))
    y = torch.stack(ys, 1) if ys else torch.zeros_like(xf)
    return y, s


def ssd_scan(x, dt, A, B, C) -> torch.Tensor:
    """Sequential state-space scan (the oracle the chunked forms match).

    x: (b, l, h, dh); dt: (b, l, h) softplus-ed timestep; A: (h,) negative
    decay per head; B/C: (b, l, n). Returns y (b, l, h, dh) in x.dtype:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t (outer) x_t; y_t = C_t . h_t."""
    return _ssd_sequential(x, dt, A, B, C)[0].to(x.dtype)


def _chunk_terms(x, dt, A, B, chunk):
    """Per-chunk fp32 quantities of the chunked form: x, dt, B and C
    reshaped to (b, nc, L, ...), the inclusive log-decay ``la`` and the
    chunk's own state contribution ``S_in`` (b, nc, h, n, dh)."""
    b, l, h, dh = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, dh).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    la = torch.cumsum(dtc * A.float(), dim=2)               # (b,nc,L,h)
    wS = torch.exp(la[:, :, -1:, :] - la) * dtc              # (b,nc,L,h)
    return xc, dtc, Bc, la, wS


def _carry(S_in, l_last):
    """States before each chunk and after the last: S_c = e^{l_L} S_{c-1}
    + S_in[c], from S_{-1} = 0."""
    s = torch.zeros_like(S_in[:, 0])
    prevs = []
    for c in range(S_in.shape[1]):
        prevs.append(s)
        s = torch.exp(l_last[:, c])[..., None, None] * s + S_in[:, c]
    return torch.stack(prevs, 1), s


def ssd_scan_chunked(x, dt, A, B, C, chunk: int = 64,
                     work_dtype=torch.float32) -> torch.Tensor:
    """Chunked (state-space duality) form, the blocked algorithm of the
    kernel: intra-chunk quadratic part plus the carried inter-chunk
    state. ``work_dtype`` rounds the big intra-chunk operands (products
    still accumulate in fp32); decay, cumsum and state stay fp32.

    Unlike ``repro.kernels.ref.ssd_scan_chunked``, the exponent is masked
    *before* ``exp``: ``where(s <= t, la_t - la_s, -inf)``. The reference
    takes ``exp`` of every (t, s) pair and multiplies by the triangle
    afterwards; above the diagonal the exponent is positive and at chunk
    128 overflows, so ``inf * 0`` gives NaN there (ROADMAP queue 3). Here
    the upper triangle is a 0 weight with a 0 gradient."""
    b, l, h, dh = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    xc, dtc, Bc, la, wS = _chunk_terms(x, dt, A, B, chunk)
    Cc = C.reshape(b, nc, chunk, n).float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]       # (b,nc,t,s,h)
    dec = torch.exp(torch.where(tri[:, :, None], diff, float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    w = (cb[..., None] * dec).to(work_dtype).float()
    xdt = (dtc[..., None] * xc).to(work_dtype).float()
    y_intra = torch.einsum("bctsh,bcshd->bcthd", w, xdt)
    S_in = torch.einsum("bcsn,bcsh,bcshd->bchnd",
                        Bc.to(work_dtype).float(), wS.to(work_dtype).float(),
                        xc.to(work_dtype).float())
    s_prev, _ = _carry(S_in, la[:, :, -1, :])
    y_inter = torch.einsum("bctn,bcth,bchnd->bcthd", Cc, torch.exp(la),
                           s_prev)
    return (y_intra + y_inter).reshape(b, l, h, dh).to(x.dtype)


def ssd_scan_chunked_with_state(x, dt, A, B, C, chunk: int = 64):
    """``ssd_scan_chunked`` plus the final recurrent state (b, h, n, dh),
    which prefill hands to decode. A length that is not a multiple of
    ``chunk`` takes the sequential scan, as in the reference."""
    l = x.shape[1]
    if l % chunk:
        y, s = _ssd_sequential(x, dt, A, B, C)
        return y.to(x.dtype), s
    y = ssd_scan_chunked(x, dt, A, B, C, chunk=chunk)
    xc, _, Bc, la, wS = _chunk_terms(x, dt, A, B, chunk)
    S_in = torch.einsum("bcsn,bcsh,bcshd->bchnd", Bc, wS, xc)
    _, s_final = _carry(S_in, la[:, :, -1, :])
    return y, s_final


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def adamw_update(p, g, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8,
                 wd=0.01):
    """One AdamW step in the reference's form (bias corrections divided
    out). Returns ``(p, m, v)``."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
    return p, m, v

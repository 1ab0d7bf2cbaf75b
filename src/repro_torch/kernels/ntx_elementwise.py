"""NTX streaming element commands: the plain versions and the launcher of
the CUDA streaming kernel (``csrc/ntx_stream.cu``).

Counterpart of ``repro.kernels.ntx_elementwise``: AXPY / ADD / SUB / MUL /
RELU / THRESH / MASK / COPY / SET, one element out per element in, as a
single command (``elementwise_pallas``) or a fused chain whose carried
value never leaves registers (``elementwise_chain_pallas``). The same
CUDA kernel, with a reduction tail, serves ``ntx_reduce``. The fused
AdamW step (``adamw_pallas``) has its own kernel, ``csrc/ntx_adamw.cu``,
and so has the fused MLP's activation backward (``csrc/ntx_act_bwd.cu``,
no TPU counterpart: the reference differentiates the epilogue with XLA).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build, ref
from .ref import f32

_OPS1 = {"relu", "thresh", "copy", "set"}
_OPS2 = {"axpy", "add", "sub", "mul", "mask"}

#: opcodes and reduction tails as ``csrc/ntx_stream.cu`` numbers them
_OPCODE = {"axpy": 0, "add": 1, "sub": 2, "mul": 3, "mask": 4, "relu": 5,
           "thresh": 6, "copy": 7, "set": 8}
_TAIL = {None: 0, "sum": 1, "min": 2, "max": 3, "argmin": 4, "argmax": 5}
#: stages the kernel takes per launch (longer chains are split)
MAX_STAGES = 8


def _apply_op(op: str, x: torch.Tensor, y, imm: float) -> torch.Tensor:
    """One streaming command applied to a block of fp32 values: the
    oracle's math, products rounded on their own (``ref._rounded``)."""
    return ref.elementwise(op, x, y, imm)


def normalize_stages(stages) -> tuple:
    stages = tuple((str(op), float(imm)) for op, imm in stages)
    for op, _ in stages:
        if op not in _OPCODE:
            raise ValueError(f"not a streaming command: {op!r}")
    return stages


def elementwise_plain(op: str, x: torch.Tensor, y=None,
                      imm: float = 0.0) -> torch.Tensor:
    """Plain version of ``elementwise_pallas``: one command over x."""
    return _apply_op(op, x, y, imm)


def elementwise_chain_plain(stages, x: torch.Tensor, ys=()) -> torch.Tensor:
    """Plain version of ``elementwise_chain_pallas``: fold the stages,
    each 2-read stage consuming the next operand of ``ys``."""
    val = x
    yi = 0
    for op, imm in normalize_stages(stages):
        y = None
        if op in _OPS2:
            y = ys[yi]
            yi += 1
        val = _apply_op(op, val, y, imm)
    return val


#: elements of a row one block of a reduction tail reduces (``kChunk`` in
#: ``csrc/ntx_stream.cu``, which refuses any other value)
STREAM_CHUNK = 4096


def stream_chunks(n: int) -> int:
    """Blocks a reduction tail splits a row of ``n`` elements into, each
    writing one partial that the row's last block merges in chunk order.
    A function of ``n`` alone, so every chain ending in the same tail
    over rows of the same length reduces in the same order."""
    return max(1, -(-int(n) // STREAM_CHUNK))


#: (device, stream) -> (counters, partials) of the reduction tails. The
#: kernel needs the counters at 0 and leaves them at 0 (each row's last
#: block resets its own), and launches on one stream run in order, so
#: each stream keeps one pair and no call allocates or clears anything.
_TAIL_SCRATCH: dict = {}


def _tail_scratch(x: torch.Tensor, stream: int, rows: int, chunks: int):
    """The counters (int32, zero) and partials (2 * rows * chunks words)
    for a tail launch on ``stream``, grown geometrically as needed."""
    key = (x.get_device(), stream)
    counters, part = _TAIL_SCRATCH.get(key, (None, None))
    if counters is None or counters.numel() < rows:
        size = max(rows, 2 * counters.numel() if counters is not None else 64)
        counters = torch.zeros(size, dtype=torch.int32, device=x.device)
    need = 2 * rows * chunks
    if part is None or part.numel() < need:
        size = max(need, 2 * part.numel() if part is not None else 1 << 12)
        part = torch.empty(size, dtype=torch.float32, device=x.device)
    _TAIL_SCRATCH[key] = (counters, part)
    return counters, part


@functools.lru_cache(maxsize=256)
def _encode(stages: tuple) -> tuple:
    """``(stages, two-read flags, opcode array, imm array, null operand
    array)`` for a tuple of (op, imm) pairs, normalized and checked once
    per chain: the serving samplers issue the same few chains at every
    step."""
    stages = normalize_stages(stages)
    if len(stages) > MAX_STAGES:
        raise ValueError(f"{len(stages)} stages > {MAX_STAGES} per launch")
    flags = tuple(op in _OPS2 for op, _ in stages)
    ops_arr = _build.ptr_array(ctypes.c_int, [_OPCODE[op] for op, _ in stages])
    imm_arr = _build.ptr_array(ctypes.c_float, [f32(i) for _, i in stages])
    no_ys = _build.ptr_array(ctypes.c_void_p, [None] * len(stages))
    return stages, flags, ops_arr, imm_arr, no_ys


def _check_stream_operand(t: torch.Tensor, shape, what: str,
                          flat: bool) -> int:
    """Check one operand of a launch and return its row stride in
    elements: ``flat`` launches take contiguous tensors (stride ``n``);
    row launches take (rows, n) views whose last axis is contiguous and
    whose rows do not overlap (a lane stack of the memory image)."""
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{what}: the stream kernel takes fp32 CUDA "
                         f"tensors, got {t.dtype} on {t.device}")
    if t.shape != shape:
        raise ValueError(f"{what}: need a {tuple(shape)} tensor, got "
                         f"{tuple(t.shape)}")
    if flat:
        if not t.is_contiguous():
            raise ValueError(f"{what}: need a contiguous {tuple(shape)} "
                             f"tensor")
        return t.numel()
    rows, n = shape
    ld = t.stride(0) if rows > 1 else n
    if (n > 1 and t.stride(1) != 1) or ld < n:
        raise ValueError(f"{what}: need a (rows, n) view with contiguous "
                         f"rows that do not overlap, got strides "
                         f"{t.stride()}")
    return ld


def stream_cuda(stages, x: torch.Tensor, ys=(), tail=None,
                n_valid: int | None = None, write_out: bool = True,
                red_int: bool = False):
    """Launch ``csrc/ntx_stream.cu``: at most ``MAX_STAGES`` (op, imm)
    stages over an fp32 CUDA tensor, each two-read stage taking the next
    of ``ys`` (of x's shape), then the optional reduction ``tail`` over
    the last axis of a (rows, n) ``x``. Contiguous operands without a
    tail stream as one flat run of any shape. Otherwise x and the ys are
    (rows, n) views whose rows are contiguous and may sit at any stride
    (the rows of a lane-batched launch are the lanes' windows in the
    memory image); ``out`` is a new contiguous tensor. Returns ``(out or
    None, red or None)``; ``red`` has one entry per row, int32 when
    ``red_int`` and the tail is an arg tail. A tail over rows of more
    than ``STREAM_CHUNK`` elements uses the stream's scratch of partials
    (:func:`_tail_scratch`); it is still one launch. Any element offset
    and stride work: unaligned rows take the kernel's scalar
    instantiation."""
    stages, flags, ops_arr, imm_arr, no_ys = _encode(tuple(stages))
    shape = x.shape
    if sum(flags) != len(ys):
        raise ValueError(f"{len(ys)} operands for {sum(flags)} two-read "
                         f"stages")
    # one flat run of contiguous elements, or (rows, n) rows with strides
    flat = tail is None and x.is_contiguous() and all(
        y.is_contiguous() for y in ys)
    if not flat and x.dim() != 2:
        raise ValueError(f"a reduction tail or a strided operand takes a "
                         f"(rows, n) tensor, got {tuple(shape)}")
    ldx = _check_stream_operand(x, shape, "x", flat)
    ldys = [_check_stream_operand(y, shape, f"ys[{i}]", flat)
            for i, y in enumerate(ys)]
    rows, n = (1, x.numel()) if flat else shape
    if n >= 1 << 31:
        raise ValueError(f"{n} elements per row: the kernel counts in int32")
    n_valid = n if n_valid is None else int(n_valid)
    stream = _build.stream_of(x)
    out = None
    if write_out:               # contiguous either way
        out = (torch.empty_like(x) if x.is_contiguous() else
               torch.empty(shape, dtype=torch.float32, device=x.device))
    red = counters = part = None
    if tail is not None:
        arg_int = red_int and tail in ("argmin", "argmax")
        red = torch.empty(rows, dtype=torch.int32 if arg_int
                          else torch.float32, device=x.device)
        chunks = stream_chunks(n)
        if chunks > 1:
            counters, part = _tail_scratch(x, stream, rows, chunks)
    ld_arr = None                  # a flat run reads no row strides
    if ys:
        yit = iter(ys)
        y_arr = _build.ptr_array(ctypes.c_void_p, [
            next(yit).data_ptr() if two else None for two in flags])
        if not flat:
            ldit = iter(ldys)
            ld_arr = _build.ptr_array(ctypes.c_longlong, [
                next(ldit) if two else n for two in flags])
    else:
        y_arr = no_ys
    with _build.on_device(x):
        code = _build.library().ntx_stream(
            x.data_ptr(), ldx, out.data_ptr() if out is not None else None,
            n, rows, n, n_valid, len(stages), ops_arr, imm_arr, y_arr,
            ld_arr, _TAIL[tail], red.data_ptr() if red is not None else None,
            int(bool(red_int)), STREAM_CHUNK,
            counters.data_ptr() if counters is not None else None,
            part.data_ptr() if part is not None else None, stream)
    _build.check(code, "ntx_stream")
    return out, red


# ----------------------------------------------------------------------
# Fused AdamW step
# ----------------------------------------------------------------------
def bias_corrections(step, b1: float, b2: float) -> tuple:
    """``(1 / (1 - b1**t), 1 / (1 - b2**t))`` computed in fp32, as the
    reference computes them from its int32 step, returned as floats
    (cached per step: the fused update asks once per leaf)."""
    return _bias_corrections(int(step), float(b1), float(b2))


@functools.lru_cache(maxsize=64)
def _bias_corrections(step: int, b1: float, b2: float) -> tuple:
    t = torch.as_tensor(step, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    bc1 = one / (one - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = one / (one - torch.tensor(b2, dtype=torch.float32) ** t)
    return float(bc1), float(bc2)


def adamw_plain(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                wd=0.01):
    """Plain version of ``_adamw_kernel``: fp32 math, the bias
    corrections as reciprocals multiplied in. Returns ``(p, m, v)``: p
    in its own dtype, m and v in fp32."""
    bc1, bc2 = bias_corrections(step, b1, b2)
    lr = f32(lr)
    g = g.float()
    m = b1 * m.float() + (1 - b1) * g
    v = b2 * v.float() + (1 - b2) * g * g
    mhat = m * bc1
    vhat = v * bc2
    pf = p.float()
    pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
    return pf.to(p.dtype), m, v


#: ``kThreads`` and ``kUnroll`` of ``csrc/ntx_adamw.cu``: threads a block,
#: 16-byte vectors in flight per thread
ADAMW_THREADS = 256
ADAMW_UNROLL = 4
#: blocks per SM the AdamW grid is capped at (past it, blocks stride):
#: at the 2048x4096 layer the grid then gives each block one pass
ADAMW_BLOCKS_PER_SM = 16


@dataclass(frozen=True)
class AdamWPlan:
    """How ``csrc/ntx_adamw.cu`` covers n elements: ``head`` elements one
    at a time, then ``vecs`` vectors of 4 (16 bytes of each fp32 operand,
    8 of a bf16 p), then ``tail`` elements one at a time, on ``blocks``
    blocks of ``ADAMW_THREADS``."""
    head: int
    vecs: int
    tail: int
    blocks: int


@functools.lru_cache(maxsize=256)
def adamw_plan(n: int, phases: tuple, sms: int) -> AdamWPlan:
    """The plan for n elements whose operands start at element ``phases``
    (each operand's address over its element size, modulo 4): when they
    all agree, the head runs up to the first 4-element boundary and the
    vectors cover the rest but for a tail of fewer than 4; when they
    disagree no vector is aligned in every operand, and every element goes
    one at a time. The grid covers the work at ``ADAMW_UNROLL`` vectors a
    thread, at most ``ADAMW_BLOCKS_PER_SM`` blocks per SM."""
    if n < 0:
        raise ValueError(f"adamw over {n} elements")
    distinct = {int(ph) % 4 for ph in phases}
    if len(distinct) == 1:
        head = min(n, -distinct.pop() % 4)
        vecs = (n - head) // 4
    else:
        head, vecs = n, 0
    tail = n - head - 4 * vecs
    work = max(-(-vecs // (ADAMW_UNROLL * ADAMW_THREADS)),
               -(-(head + tail) // ADAMW_THREADS), 1)
    return AdamWPlan(head, vecs, tail,
                     min(work, max(1, sms) * ADAMW_BLOCKS_PER_SM))


def _phase(t: torch.Tensor) -> int:
    return (t.data_ptr() // t.element_size()) % 4


def _empty_at(like: torch.Tensor, phase: int, dtype) -> torch.Tensor:
    """An uninitialised tensor of ``like``'s shape whose first element
    sits at ``phase`` modulo 4 elements, so that it shares the inputs'
    16-byte boundaries (phase 0: a fresh allocation)."""
    if phase == 0:
        return torch.empty(like.shape, dtype=dtype, device=like.device)
    n = like.numel()
    buf = torch.empty(n + 3, dtype=dtype, device=like.device)
    off = (phase - _phase(buf)) % 4
    return buf[off:off + n].view(like.shape)


@functools.lru_cache(maxsize=64)
def _hyper(lr: float, b1: float, b2: float, eps: float, wd: float,
           step: int):
    """The kernel's nine fp32 scalars, ``(lr, b1, 1 - b1, b2, 1 - b2,
    eps, wd, bc1, bc2)``, as one ctypes array: made once per step and
    setting, not per leaf."""
    bc1, bc2 = bias_corrections(step, b1, b2)
    vals = (f32(lr), f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(eps),
            f32(wd), bc1, bc2)
    return _build.ptr_array(ctypes.c_float, vals)


def adamw_cuda(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
               wd=0.01):
    """Launch ``csrc/ntx_adamw.cu`` over same-shaped CUDA tensors: p fp32
    or bf16, g/m/v fp32 (cast here if not). Out of place: returns new
    ``(p, m, v)``, placed at p's phase modulo 16 bytes, so that operands
    that start off a 16-byte boundary together still take the vector
    route (:func:`adamw_plan`)."""
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adamw takes an fp32 or bf16 p, got {p.dtype}")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"adamw shapes p {tuple(p.shape)} g "
                         f"{tuple(g.shape)} m {tuple(m.shape)} v "
                         f"{tuple(v.shape)}")
    hyper = _hyper(float(lr), float(b1), float(b2), float(eps), float(wd),
                   int(step))
    p = p.contiguous()
    g, m, v = (t.float().contiguous() for t in (g, m, v))
    ins = (p, g, m, v)
    phases = tuple(_phase(t) for t in ins)
    phase = phases[0] if phases.count(phases[0]) == 4 else 0
    po = _empty_at(p, phase, p.dtype)
    mo, vo = _empty_at(m, phase, m.dtype), _empty_at(v, phase, v.dtype)
    if phase:   # outputs at phase 0 are fresh allocations, so aligned
        phases += (_phase(po), _phase(mo), _phase(vo))
    plan = adamw_plan(p.numel(), phases, _build.sm_count(p.get_device()))
    with _build.on_device(p):
        code = _build.library().ntx_adamw(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            po.data_ptr(), mo.data_ptr(), vo.data_ptr(), p.numel(), hyper,
            int(p.dtype == torch.bfloat16), plan.head, plan.vecs, plan.blocks,
            _build.stream_of(p))
    _build.check(code, "ntx_adamw")
    return po, mo, vo


# ----------------------------------------------------------------------
# The fused MLP's activation backward: csrc/ntx_act_bwd.cu
# ----------------------------------------------------------------------
#: activations as ``csrc/ntx_act_bwd.cu`` numbers them
ACT_BWD = {"swiglu": 0, "gelu": 1}
#: sqrt(2 / pi), c and 3 c of the tanh GELU, as the kernel's fp32 literals
_GELU_K0, _GELU_C, _GELU_C3 = f32(0.7978845608028654), f32(0.044715), \
    f32(0.134145)


def act_bwd_plain(act: str, dh: torch.Tensor, a1: torch.Tensor,
                  gate: torch.Tensor | None, out_dtype=torch.float32):
    """Plain version of the activation backward: ``(da1, dgate, h)`` in
    ``out_dtype`` from fp32 ``dh``, ``a1`` and (SwiGLU) ``gate``; GELU is
    the tanh form and has no gate (``dgate`` None). Each fp32 operation is
    one rounding, in the kernel's order, so the two are bit-equal on the
    card; ``h`` is the forward's hidden (the SwiGLU ``h`` has the bits of
    the GEMM epilogue's)."""
    if act not in ACT_BWD:
        raise ValueError(f"activation {act!r}: the backward takes "
                         f"{sorted(ACT_BWD)}")
    a = a1.float()
    dh = dh.float()
    if act == "swiglu":
        sig = torch.reciprocal(torch.exp(-a) + 1.0)
        silu = a * sig
        h = silu * gate.float()
        dgate = dh * silu
        dsilu = sig * ((a * (1.0 - sig)) + 1.0)
        da1 = (dh * gate.float()) * dsilu
        return da1.to(out_dtype), dgate.to(out_dtype), h.to(out_dtype)
    x2 = a * a
    t = torch.tanh((a + (x2 * a) * _GELU_C) * _GELU_K0)
    onept = t + 1.0
    half_a = a * 0.5
    h = half_a * onept
    sech2 = 1.0 - t * t
    dinner = ((x2 * _GELU_C3) + 1.0) * _GELU_K0
    dg = onept * 0.5 + (half_a * sech2) * dinner
    return (dh * dg).to(out_dtype), None, h.to(out_dtype)


def act_bwd_cuda(act: str, dh: torch.Tensor, a1: torch.Tensor,
                 gate: torch.Tensor | None, out_dtype=torch.float32):
    """Launch ``csrc/ntx_act_bwd.cu``: one pass over fp32 ``dh``, ``a1``
    and (SwiGLU) ``gate`` of one shape (copied if not contiguous), writing
    ``(da1, dgate, h)`` in ``out_dtype`` (fp32 or bf16; GELU: ``dgate``
    None)."""
    if act not in ACT_BWD:
        raise ValueError(f"activation {act!r}: the backward takes "
                         f"{sorted(ACT_BWD)}")
    swiglu = act == "swiglu"
    ins = (dh, a1, gate) if swiglu else (dh, a1)
    if any(t.dtype != torch.float32 or t.shape != dh.shape for t in ins):
        raise ValueError("the activation backward takes fp32 dh, a1 and "
                         "gate of one shape")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the activation backward writes fp32 or bf16, not "
                         f"{out_dtype}")
    dh, a1 = dh.contiguous(), a1.contiguous()
    gate = gate.contiguous() if swiglu else None
    da1 = torch.empty(dh.shape, dtype=out_dtype, device=dh.device)
    h = torch.empty_like(da1)
    dgate = torch.empty_like(da1) if swiglu else None
    with _build.on_device(dh):
        code = _build.library().ntx_act_bwd(
            dh.data_ptr(), a1.data_ptr(),
            gate.data_ptr() if swiglu else None, da1.data_ptr(),
            dgate.data_ptr() if swiglu else None, h.data_ptr(), dh.numel(),
            ACT_BWD[act], int(out_dtype == torch.bfloat16),
            _build.stream_of(dh))
    _build.check(code, "ntx_act_bwd")
    return da1, dgate, h

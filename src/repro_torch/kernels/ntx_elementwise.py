"""NTX streaming element commands: the plain versions and the launcher of
the CUDA streaming kernel (``csrc/ntx_stream.cu``).

Counterpart of ``repro.kernels.ntx_elementwise``: AXPY / ADD / SUB / MUL /
RELU / THRESH / MASK / COPY / SET, one element out per element in, as a
single command (``elementwise_pallas``) or a fused chain whose carried
value never leaves registers (``elementwise_chain_pallas``). The same
CUDA kernel, with a reduction tail, serves ``ntx_reduce``. The fused
AdamW step (``adamw_pallas``) has its own kernel, ``csrc/ntx_adamw.cu``.
"""
from __future__ import annotations

import ctypes

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


def _check_stream_operand(t: torch.Tensor, shape, what: str) -> None:
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{what}: the stream kernel takes fp32 CUDA "
                         f"tensors, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous {tuple(shape)} tensor, "
                         f"got {tuple(t.shape)}")


def stream_cuda(stages, x: torch.Tensor, ys=(), tail=None,
                n_valid: int | None = None, write_out: bool = True,
                red_int: bool = False):
    """Launch ``csrc/ntx_stream.cu`` over a contiguous fp32 (rows, n) CUDA
    tensor: at most ``MAX_STAGES`` stages, then the optional reduction
    ``tail``. Returns ``(out or None, red or None)``; ``red`` has one
    entry per row, int32 when ``red_int`` and the tail is an arg tail."""
    stages = normalize_stages(stages)
    if len(stages) > MAX_STAGES:
        raise ValueError(f"{len(stages)} stages > {MAX_STAGES} per launch")
    rows, n = x.shape
    _check_stream_operand(x, (rows, n), "x")
    for i, y in enumerate(ys):
        _check_stream_operand(y, (rows, n), f"ys[{i}]")
    n_valid = n if n_valid is None else int(n_valid)
    out = torch.empty_like(x) if write_out else None
    red = None
    if tail is not None:
        arg_int = red_int and tail in ("argmin", "argmax")
        red = torch.empty(rows, dtype=torch.int32 if arg_int
                          else torch.float32, device=x.device)
    y_ptrs, yi = [], 0
    for op, _ in stages:
        if op in _OPS2:
            y_ptrs.append(ys[yi].data_ptr())
            yi += 1
        else:
            y_ptrs.append(None)
    if yi != len(ys):
        raise ValueError(f"{len(ys)} operands for {yi} two-read stages")
    ops_arr = _build.ptr_array(ctypes.c_int, [_OPCODE[op] for op, _ in stages])
    imm_arr = _build.ptr_array(ctypes.c_float, [f32(i) for _, i in stages])
    ys_arr = _build.ptr_array(ctypes.c_void_p, y_ptrs)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.ntx_stream(
            x.data_ptr(), out.data_ptr() if out is not None else None,
            rows, n, n_valid, len(stages), ops_arr, imm_arr, ys_arr,
            _TAIL[tail], red.data_ptr() if red is not None else None,
            int(bool(red_int)), _build.stream_of(x))
    _build.check(code, "ntx_stream")
    return out, red


# ----------------------------------------------------------------------
# Fused AdamW step
# ----------------------------------------------------------------------
def bias_corrections(step, b1: float, b2: float) -> tuple:
    """``(1 / (1 - b1**t), 1 / (1 - b2**t))`` computed in fp32, as the
    reference computes them from its int32 step, returned as floats."""
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


def adamw_cuda(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
               wd=0.01):
    """Launch ``csrc/ntx_adamw.cu`` over same-shaped CUDA tensors: p fp32
    or bf16, g/m/v fp32 (cast here if not). Out of place: returns new
    ``(p, m, v)``."""
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adamw takes an fp32 or bf16 p, got {p.dtype}")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"adamw shapes p {tuple(p.shape)} g "
                         f"{tuple(g.shape)} m {tuple(m.shape)} v "
                         f"{tuple(v.shape)}")
    bc1, bc2 = bias_corrections(step, b1, b2)
    p = p.contiguous()
    g, m, v = (t.float().contiguous() for t in (g, m, v))
    po, mo, vo = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(p.device):
        code = lib.ntx_adamw(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            po.data_ptr(), mo.data_ptr(), vo.data_ptr(), p.numel(),
            f32(lr), f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(eps),
            f32(wd), bc1, bc2, int(p.dtype == torch.bfloat16),
            _build.stream_of(p))
    _build.check(code, "ntx_adamw")
    return po, mo, vo

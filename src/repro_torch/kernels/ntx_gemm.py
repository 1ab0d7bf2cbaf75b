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
            acc = acc + operands[i].reshape(1, -1).float()
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
    normalized (kind, imm, operand) triples."""
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


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32,
              epilogue=(), compensated: bool = False) -> torch.Tensor:
    """Launch ``csrc/ntx_gemm.cu``: a (m, k) @ b (k, n), both fp32 or both
    bf16, output fp32 or bf16; array epilogue operands are passed as
    contiguous fp32 ((n,) for bias, (m, n) otherwise). ``compensated``
    takes the kernel's Neumaier variant over KAHAN_SLAB-deep slabs."""
    if a.dtype != b.dtype or a.dtype not in _GEMM_DTYPES:
        raise ValueError(f"ntx_gemm takes two fp32 or two bf16 operands, "
                         f"got {a.dtype} @ {b.dtype}")
    if out_dtype not in _GEMM_DTYPES:
        raise ValueError(f"ntx_gemm writes fp32 or bf16, not {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if len(epilogue) > MAX_EPILOGUE:
        raise ValueError(f"{len(epilogue)} epilogue stages > {MAX_EPILOGUE}")
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    keep, ptrs = [], []
    for kind, _, operand in epilogue:
        if kind not in EPILOGUE_ARRAY_KINDS:
            ptrs.append(None)
            continue
        want = (n,) if kind == "bias" else (m, n)
        op = operand.to(torch.float32).reshape(want).contiguous()
        keep.append(op)
        ptrs.append(op.data_ptr())
    kinds = _build.ptr_array(ctypes.c_int, [_KIND[k] for k, _, _ in epilogue])
    imms = _build.ptr_array(ctypes.c_float, [f32(i) for _, i, _ in epilogue])
    ops_arr = _build.ptr_array(ctypes.c_void_p, ptrs)
    lib = _build.library()
    with torch.cuda.device(a.device):
        code = lib.ntx_gemm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                            int(a.dtype == torch.bfloat16),
                            int(out_dtype == torch.bfloat16),
                            int(compensated), len(epilogue),
                            kinds, imms, ops_arr, _build.stream_of(a))
    _build.check(code, "ntx_gemm")
    return c

"""Plain PyTorch oracles for the kernels this package ports.

The counterpart of ``repro.kernels.ref`` for the slice's kernels: GEMM,
the streaming command set, the row reductions and reference attention.
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
    resolve ties to the first index, like ``np.argmax``."""
    if op == "sum":
        return x.sum(-1)
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

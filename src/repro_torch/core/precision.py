"""Wide-accumulator (PCS) precision emulation and study (paper §II-C).

Counterpart of ``repro.core.precision``. The silicon accumulates 48-bit
products in a ~300-bit partial-carry-save register and rounds ONCE at
write-back; the paper reports an RMSE 1.7x lower than a conventional
fp32 FPU on a DNN convolution layer. This module provides:

  * exact dot products (the PCS semantics) via math.fsum,
  * naive fp32 chained dots (the conventional-FPU baseline),
  * Neumaier (Kahan) compensated summation on tensors, the accumulator of
    the compensated GEMM (``ops.gemm(compensated=True)``),
  * the RMSE-ratio study reproducing the paper's claim.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.ntx_gemm import kahan_add

__all__ = ["dot_fp32_chained", "dot_pcs", "dot_f64", "kahan_add",
           "kahan_sum", "kahan_dot", "conv_layer_rmse_study"]


# ----------------------------------------------------------------------
# Reference accumulators (host)
# ----------------------------------------------------------------------
def dot_fp32_chained(a: np.ndarray, b: np.ndarray) -> np.float32:
    """Conventional FPU: round after every FMA (sequential order)."""
    acc = np.float32(0.0)
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    for x, y in zip(a, b):
        acc = np.float32(x * y + acc)
    return acc


def dot_pcs(a: np.ndarray, b: np.ndarray) -> np.float32:
    """PCS semantics: every product exact, one rounding at the end.

    fp32 x fp32 products are exact in float64, and math.fsum returns the
    correctly-rounded double sum => one final rounding to fp32, like the
    ~300-bit PCS register with deferred rounding.
    """
    prods = [float(np.float32(x)) * float(np.float32(y)) for x, y in zip(a, b)]
    return np.float32(math.fsum(prods))


def dot_f64(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a.astype(np.float64), b.astype(np.float64)))


# ----------------------------------------------------------------------
# Compensated accumulation on tensors
# ----------------------------------------------------------------------
def kahan_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Compensated sum along ``axis`` (fp32 in, fp32 out): a loop over the
    summed axis in place of the reference's ``lax.scan``, each step one
    Neumaier ``kahan_add`` over all the other axes at once."""
    x = torch.movedim(x, axis, 0)
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    comp = torch.zeros_like(acc)
    for xi in x:
        acc, comp = kahan_add(acc, comp, xi)
    return acc + comp


def kahan_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated dot product over the last axis."""
    return kahan_sum(a * b)


# ----------------------------------------------------------------------
# RMSE study (paper §II-C: "RMSE 1.7x lower than a 32-bit FPU")
# ----------------------------------------------------------------------
def conv_layer_rmse_study(seed: int = 0, n_outputs: int = 256,
                          reduction: int = 3 * 3 * 64,
                          device="cuda") -> dict:
    """Reproduce the conv-layer accumulation-error experiment.

    Draws ``n_outputs`` random conv reductions (kernel 3x3, 64 input
    channels by default, a typical DNN layer) in the reference's order,
    computes each output with (a) chained fp32 FMAs, (b) Kahan fp32 on
    ``device`` (all outputs at once, each bit-equal to its own
    ``kahan_dot``), (c) PCS/exact, against the f64 reference, and reports
    RMSEs and the naive/PCS ratio."""
    rng = np.random.default_rng(seed)
    xs, ws = [], []
    for _ in range(n_outputs):
        xs.append(rng.standard_normal(reduction).astype(np.float32))
        ws.append((rng.standard_normal(reduction)
                   / math.sqrt(reduction)).astype(np.float32))
    kahan = kahan_dot(torch.from_numpy(np.stack(xs)).to(device),
                      torch.from_numpy(np.stack(ws)).to(device)).cpu()
    err_naive, err_kahan, err_pcs = [], [], []
    for x, w, k in zip(xs, ws, kahan.numpy()):
        ref = dot_f64(x, w)
        err_naive.append(float(dot_fp32_chained(x, w)) - ref)
        err_kahan.append(float(np.float32(k)) - ref)
        err_pcs.append(float(dot_pcs(x, w)) - ref)

    def rmse(e):
        return math.sqrt(sum(v * v for v in e) / len(e))

    r_naive, r_kahan, r_pcs = rmse(err_naive), rmse(err_kahan), rmse(err_pcs)
    return {
        "rmse_fp32_chained": r_naive,
        "rmse_kahan": r_kahan,
        "rmse_pcs": r_pcs,
        "ratio_naive_over_pcs": r_naive / max(r_pcs, 1e-30),
        "ratio_naive_over_kahan": r_naive / max(r_kahan, 1e-30),
    }

"""NTX streaming reductions (SUM / MIN / MAX / ARGMIN / ARGMAX): the plain
versions of ``reduce_pallas`` and ``chain_reduce_pallas``.

The CUDA path is the streaming kernel of ``ntx_elementwise`` with a
reduction tail (``csrc/ntx_stream.cu``): the chain value is written back
and reduced in the same pass; arg tails carry the index counter and
resolve ties first-wins, like ``np.argmax``.
"""
from __future__ import annotations

import torch

from . import ref
from .ntx_elementwise import elementwise_chain_plain

REDUCE_OPS = ("sum", "min", "max", "argmin", "argmax")
_INIT = {"sum": 0.0, "min": float("inf"), "max": float("-inf"),
         "argmin": float("inf"), "argmax": float("-inf")}


def reduce_plain(op: str, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``reduce_pallas``: (rows, n) -> (rows,); fp32 for
    sum/min/max, int32 for the arg ops."""
    if op not in REDUCE_OPS:
        raise ValueError(op)
    return ref.reduce(op, x)


def chain_reduce_plain(stages, red: str, x: torch.Tensor, ys=(),
                       n_valid: int | None = None):
    """Plain version of ``chain_reduce_pallas``: ``(chain_out (rows, n),
    reduction (rows,))``. Columns at or past ``n_valid`` contribute the
    reduction's identity; arg results are fp32 indices, as the kernel
    stores them."""
    if red not in REDUCE_OPS:
        raise ValueError(red)
    val = elementwise_chain_plain(stages, x, ys)
    n = val.shape[-1]
    n_valid = n if n_valid is None else n_valid
    v = val
    if n_valid < n:
        col = torch.arange(n, device=val.device)
        v = torch.where(col < n_valid, val, torch.full_like(val, _INIT[red]))
    r = ref.reduce(red, v)
    return val, r.to(torch.float32)

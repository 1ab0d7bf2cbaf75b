"""Distributed-optimization collectives, the counterpart of
``repro.distributed.collectives``.

``compressed_psum_mean``: int8-quantized gradient all-reduce with
per-chunk scales, built from reduce-scatter (all_to_all) + local fp32
reduction + all-gather, for ~3.5x less wire traffic than an fp32
all-reduce. Used with ``error_feedback`` (the residual carried in the
optimizer state) so compression noise does not bias the optimizer.

Where the reference's functions run under ``shard_map`` and take an
``axis_name``, these run in every rank's program and take the
``ProcessGroup`` of that axis (``mesh.get_group("data")``). No train
step calls them, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale). Both
    divisions are true divisions on every device (a CUDA tensor divided
    by a Python number is multiplied by its reciprocal, one rounding
    more), so the card's bytes are the CPU's and the reference's."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-30) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n, *x.shape))
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out


def compressed_psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over ``group`` with an int8 wire format.

    Stage 1 (reduce-scatter): all_to_all of int8 chunks; each rank
    dequantizes and sums its chunk in fp32. Stage 2 (all-gather):
    requantize the reduced chunk, all_gather int8. Wire bytes: 2 n/4
    elements against 2 n fp32 ones."""
    n = dist.get_world_size(group)
    shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    size = flat.numel()
    pad = (-size) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1)

    q, scale = quantize_int8(chunks)
    # every rank receives the i-th chunk from every peer
    qs = torch.empty_like(q)
    dist.all_to_all_single(qs, q, group=group)                # (n, chunk)
    scales = _gather(scale, group)                             # (n,)
    part = (qs.to(torch.float32) * scales[:, None]).sum(0) / n

    q2, s2 = quantize_int8(part)
    gq = _gather(q2, group)                                    # (n, chunk)
    gs = _gather(s2, group)                                    # (n,)
    out = (gq.to(torch.float32) * gs[:, None]).reshape(-1)
    out = out[:size] if pad else out
    return out.reshape(shape)


def error_feedback(grad: torch.Tensor, residual: torch.Tensor,
                   compress_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF compression: apply compress_fn to (grad + residual), carry the
    quantization error into the next step."""
    g = grad + residual
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale)
    new_residual = g - deq
    return compress_fn(deq), new_residual


def psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)

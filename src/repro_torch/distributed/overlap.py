"""Compute/communication overlap primitives, the counterpart of
``repro.distributed.overlap``.

``ring_allgather_matmul``: the TP/SP boundary product ``all_gather(x) @
W`` restructured as a ring: each step multiplies the sequence chunk held
while the next chunk travels in, so the transfer hides behind the
product. ``ring_matmul_reducescatter``: the row-parallel product followed
by a reduce-scatter over the sequence, each partial sum travelling while
the next chunk's product runs. The reference's ``collective_permute``
steps are ``batch_isend_irecv`` hops to the next rank of ``group``; each
hop is posted before the step's product and waited for after it. The
products are fp32 (the reference's ``preferred_element_type``), plain
``torch.matmul`` as in the reference, outside any kernel.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ._p2p import finish, matmul_f32, start_hop


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                          group) -> torch.Tensor:
    """x: (s_local, d) sequence-sharded; w: (d, f_local) column-sharded.
    Returns (s_global, f_local) = all_gather(x, seq) @ w, ring-overlapped.
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    s_local = x.shape[0]
    out = torch.zeros((n * s_local, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    x_cur = x.contiguous()
    for i in range(n):
        # the chunk held started at rank (idx - i) mod n
        src = (idx - i) % n
        x_nxt = torch.empty_like(x_cur) if i < n - 1 else None
        reqs = (start_hop(x_cur, x_nxt, group, (idx + 1) % n, (idx - 1) % n)
                if x_nxt is not None else [])
        out[src * s_local:(src + 1) * s_local] = matmul_f32(x_cur, w)
        finish(reqs)
        x_cur = x_nxt
    return out.to(x.dtype)


def ring_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor,
                              group) -> torch.Tensor:
    """x: (s_global, d_local); w: (d_local, f). The row-parallel product
    followed by a reduce-scatter over the sequence, as a ring. Returns
    (s_global / n, f): this rank's sequence shard of x @ w summed over
    ``group``."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    s_local = x.shape[0] // n
    acc = None
    for i in range(n):
        # the partial sum comes in from the previous rank (zeros at step
        # 0) while this rank multiplies the chunk it then adds: chunk
        # (idx - i - 1) mod n, which finishes here at the last step
        src = (idx - i - 1) % n
        reqs, got = [], None
        if i > 0:
            got = torch.empty_like(acc)
            reqs = start_hop(acc, got, group, (idx + 1) % n, (idx - 1) % n)
        y = matmul_f32(x[src * s_local:(src + 1) * s_local], w)
        finish(reqs)
        acc = y if got is None else got + y
    return acc.to(x.dtype)

"""Point-to-point hops around a process group, shared by the ring
products and the pipeline."""
from __future__ import annotations

import torch
import torch.distributed as dist


def start_hop(send, recv, group, to: int, frm: int):
    """Post ``send`` to group rank ``to`` and ``recv`` from group rank
    ``frm`` (either may be None) as one batch; returns the requests."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, to), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, frm), group))
    return dist.batch_isend_irecv(ops) if ops else []


def finish(reqs) -> None:
    for r in reqs:
        r.wait()


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32)``: the product of the
    operands' values, accumulated and returned in fp32."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))

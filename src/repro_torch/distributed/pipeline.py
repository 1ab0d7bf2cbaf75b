"""GPipe-style pipeline parallelism over a mesh axis, the counterpart of
``repro.distributed.pipeline``.

Pipeline stages map onto an axis (typically ``pod``: stage s on pod s).
Microbatches stream through the stages on the classic (n_micro + n_stage
- 1)-step schedule; activations hop from stage to stage with
``batch_isend_irecv`` (the reference's ``collective_permute``), and the
last stage's results are summed to every stage. Each rank runs its own
stage's program (the reference's ``shard_map`` body): a stage skips its
body on the schedule's idle steps and sends zeros, where the reference
computes and masks it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ._p2p import finish, start_hop
from .sharding import local_part


def gpipe(body: Callable, group):
    """Build a pipelined apply over the ranks of ``group`` (stage = group
    rank): ``body(stage_params, x_micro) -> y_micro`` of the microbatch's
    shape. Returns ``run(params_local, xs)``: ``params_local`` this
    stage's parameters, ``xs`` (n_micro, mb, ...) microbatches (stage 0
    reads them). Output: (n_micro, mb, ...) on every stage."""

    def run(params_local, xs):
        n_stage = dist.get_world_size(group)
        idx = dist.get_rank(group)
        n_micro = xs.shape[0]
        ys = torch.zeros_like(xs)
        cur = torch.zeros_like(xs[0])        # the activation entering here
        for t in range(n_micro + n_stage - 1):
            active = 0 <= t - idx < n_micro
            if active:
                y = body(params_local, xs[t] if idx == 0 else cur)
            else:
                y = torch.zeros_like(cur)
            if active and idx == n_stage - 1:
                ys[t - (n_stage - 1)] = y    # the last stage collects
            # hop to the next stage (the first stage receives zeros)
            nxt = torch.zeros_like(cur)
            finish(start_hop(y if idx < n_stage - 1 else None,
                             nxt if idx > 0 else None, group, idx + 1,
                             idx - 1))
            cur = nxt
        # results live on the last stage only; sum them to every stage
        dist.all_reduce(ys, group=group)
        return ys

    return run


def pipelined_apply(mesh, body: Callable, stage_axis: str, params_specs,
                    x_spec, y_spec):
    """:func:`gpipe` over ``stage_axis`` of ``mesh``, on global inputs:
    ``run(params, xs)`` hands :func:`gpipe` this rank's blocks of
    ``params`` and ``xs`` under their specs
    (:class:`repro_torch.distributed.sharding.P`) and returns this rank's
    block of the output, ``y_spec`` saying how the blocks assemble (the
    reference's ``out_specs``)."""
    run = gpipe(body, mesh.get_group(stage_axis))

    def apply(params, xs):
        return run(local_part(params, params_specs, mesh),
                   local_part(xs, x_spec, mesh))
    return apply

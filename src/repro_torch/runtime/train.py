"""The train loop on one device, with the reference's fault tolerance;
the counterpart of ``repro.runtime.train``.

  * checkpoint/restart: ``CheckpointManager`` (atomic, async, keep-k)
    saving ``{params, opt, data_step}`` in the reference's stacked
    layout, so either package resumes the other's checkpoints;
    ``resume="auto"`` restarts from the newest one;
  * preemption: SIGTERM requests a save at the next step boundary;
  * straggler watchdog: steps slower than ``straggler_z`` sigma of the
    step-time EMA are counted (the first step, which builds the kernels,
    is left out);
  * NaN fuse: a non-finite loss is counted and aborts the run after
    ``max_bad_steps`` in a row. As in the reference's code (and unlike
    its docstring), the step's returned params are kept all the same.

The step is eager PyTorch: autograd through ``Model.loss`` (each layer
recomputed in the backward, ``cfg.remat``; attention and the MLP are
autograd Functions whose backward kernels run on the card, the MoE FFN
is differentiated by PyTorch itself), gradients
widened to fp32 and clipped per tensor by ``apply_updates``. With ``multistream_plan`` (the default, as in the
reference) the run also plans and prices the optimizer update as a
multi-cluster descriptor program (:func:`plan_update_multistream`) into
``stats["multistream"]``; the plan launches nothing.

On a mesh (``Trainer(mesh=...)``, :func:`make_train_step`) every rank
runs the same per-rank program, the counterpart of what the reference's
``jit`` with shardings becomes per device: parameters are DTensors under
``param_specs``, the optimizer state under ``opt_state_specs`` (ZeRO-1);
each rank takes its block of the global batch (``batch_specs``), runs
the model on its parameters' local blocks (every family's layers
tensor-parallel over ``model``: attention heads and MLPs Megatron-style,
MoE experts, Mamba-2's SSD heads; ``models/common.py``), and its
gradients, its share of the global mean loss's, are summed over the data
axes onto its optimizer slice (a reduce-scatter); the clip's global norm
sums every block once; each rank updates its slice, and the new
parameters are all-gathered over the data axes. Checkpoints hold the
reference's stacked layout of the whole state, written by rank 0.
With ``cfg.ctx_parallel`` GQA self-attention is context-parallel over
``model`` (``models/attention.py``), its projections stored replicated
(``ctx_replicate_weights``, the reference's default) or sharded and
gathered each layer; their optimizer state keeps the sharded specs
(ZeRO-1 over ``opt_state_specs``, as the reference's dry run places it).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
import contextlib
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.elastic import reshard_checkpoint
from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.models import ArchConfig, Model
from repro_torch.models.common import (make_tensor_parallel, shard_range,
                                       tensor_parallel)
from repro_torch.models.convert import (named_from_reference, reference_path,
                                        to_reference)
from repro_torch.models.transformer import layer_schedule
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    resume: str = "auto"            # auto | none
    straggler_z: float = 3.0
    max_bad_steps: int = 10
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    multistream_plan: bool = True   # schedule the per-tensor update streams


def microbatches(batch: Dict[str, torch.Tensor], accum: int):
    """Split a batch into (accum, b/accum, ...) microbatches. ``pos3``
    (3, b, s) carries the batch on axis 1, the rest on axis 0."""
    def split(k, v):
        if k == "pos3":
            return v.reshape(v.shape[0], accum, -1,
                             *v.shape[2:]).movedim(1, 0)
        return v.reshape(accum, -1, *v.shape[1:])
    return {k: split(k, v) for k, v in batch.items()}


def build_step_fn(cfg: ArchConfig, opt_cfg: AdamWConfig):
    """The train step: gradients (accumulated in fp32 over
    ``cfg.grad_accum`` microbatches) -> AdamW. ``step_fn(params,
    opt_state, batch)`` writes the new values into ``params`` (the
    module) and returns ``(params, new_opt_state, loss, metrics)``. The
    two halves are profiler ranges, ``train_step.grads`` and
    ``train_step.optimizer``."""
    model = Model(cfg)
    accum = max(1, cfg.grad_accum)

    def _grads(params, batch):
        named = dict(params.named_parameters())
        plist = list(named.values())
        if accum == 1:
            loss, metrics = model.loss(params, batch)
            # in the params' dtype: apply_updates widens each as it goes
            grads = dict(zip(named, torch.autograd.grad(loss, plist)))
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = microbatches(batch, accum)
            gacc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for n, p in named.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=plist[0].device)
            for i in range(accum):
                l, _ = model.loss(params, {k: v[i] for k, v in micro.items()})
                for n, g in zip(named, torch.autograd.grad(l, plist)):
                    gacc[n] += g.float()
                lsum = lsum + l.detach()
            grads = {n: g / accum for n, g in gacc.items()}
            loss, metrics = lsum / accum, {}
        return loss, metrics, grads

    def step_fn(params, opt_state, batch):
        with torch.profiler.record_function("train_step.grads"):
            loss, metrics, grads = _grads(params, batch)
        with torch.profiler.record_function("train_step.optimizer"):
            named = dict(params.named_parameters())
            new_params, new_state = apply_updates(opt_cfg, named, grads,
                                                  opt_state)
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(new_params[n])
        return params, new_state, loss, metrics

    return step_fn


# ----------------------------------------------------------------------
# The step on a mesh
# ----------------------------------------------------------------------
def check_mesh(cfg: ArchConfig, mesh) -> None:
    """Refuse what the mesh step does not do: a model axis that leaves a
    rank without work: fewer attention heads or SSD heads than ranks
    (they split evenly), or an
    empty stored block of the experts, of the SSD heads, of d_ff (where a
    layer has an MLP), of the shared experts' d_ff_expert or of the
    vocabulary (``torch.chunk``'s blocks, whose last ones may be
    empty)."""
    nm = shd.axis_sizes(mesh)["model"]
    if nm == 1:
        return
    kinds = ({"attn_mlp"} if cfg.encoder_decoder
             else set(layer_schedule(cfg)[0]))
    attn = any(k.startswith("attn") for k in kinds)
    # heads split evenly over the ranks; the rest as their stored blocks
    short = [f"{what} {n}" for what, n, on in (
        ("n_heads", cfg.n_heads, attn), ("ssm_heads", cfg.ssm_heads, cfg.ssm))
        if on and n < nm]
    short += [f"{what} {n}" for what, n, on in (
        ("padded_vocab", cfg.padded_vocab, True),
        ("d_ff", cfg.d_ff, any(k.endswith("_mlp") for k in kinds)),
        ("n_experts", cfg.n_experts, cfg.moe),
        ("ssm_heads", cfg.ssm_heads, cfg.ssm and cfg.ssm_heads >= nm),
        ("d_ff_expert x n_shared_experts",
         cfg.d_ff_expert * cfg.n_shared_experts,
         cfg.moe and cfg.n_shared_experts > 0))
        if on and shard_range(n, nm, nm - 1)[0] >= n]
    if short:
        raise ValueError(f"{cfg.name}: a model axis of {nm} leaves ranks "
                         f"without a block of {short}")


def grad_placements(mesh, pl) -> list:
    """Placements of a parameter's gradient as autograd leaves it on a
    rank: a share of the sum over the data axes (``Partial``); on
    ``model`` the parameter's own block where it is sharded, and where it
    is replicated the whole gradient (``Replicate``): the layers hand
    every replicated tensor to a model-split region through ``tp_copy``
    (the residual's norms under the sequence-parallel residual too), so
    each rank's gradient of a replicated leaf is the whole one."""
    return [Partial() if axis != "model" else
            p if isinstance(p, Shard) else Replicate()
            for axis, p in zip(mesh.mesh_dim_names, pl)]


@contextlib.contextmanager
def local_params(module: torch.nn.Module, local: Mapping[str, Any]):
    """``module``'s parameters read as ``local``'s tensors (this rank's
    blocks) inside the block, as the model's functions read them."""
    saved = []
    for name, t in local.items():
        owner, attr = shd._owner(module, name)
        saved.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = t
    try:
        yield module
    finally:
        for owner, attr, p in saved:
            owner._parameters[attr] = p


def local_batch(mesh, batch: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch under ``batch_specs``."""
    specs = shd.batch_specs(mesh, dict(batch))
    return {k: shd.local_part(v, specs[k], mesh).contiguous()
            for k, v in batch.items()}


def init_sharded_opt_state(mesh, cfg: ArchConfig,
                           params: torch.nn.Module) -> dict:
    """``init_opt_state`` of a module with DTensor parameters: the fp32
    master and zero moments as DTensors under ``named_opt_specs``."""
    named = dict(params.named_parameters())
    ospecs = shd.named_opt_specs(mesh, cfg, named)
    master, m, v = {}, {}, {}
    with torch.no_grad():
        for n, p in named.items():
            pl = shd.placements(ospecs[n], mesh)
            loc = p.detach().redistribute(mesh, pl).to_local().to(
                torch.float32, copy=True)
            master[n] = shd.as_dtensor(loc, mesh, pl, p.shape)
            m[n] = shd.as_dtensor(torch.zeros_like(loc), mesh, pl, p.shape)
            v[n] = shd.as_dtensor(torch.zeros_like(loc), mesh, pl, p.shape)
    return {"master": master, "m": m, "v": v, "step": 0}


def _count_once(mesh, pl) -> bool:
    """True on the one rank of each replica group of a block: coordinate
    0 on every mesh dimension where the block is replicated."""
    return all(c == 0 for c, p in zip(mesh.get_coordinate(), pl)
               if not isinstance(p, Shard))


def build_mesh_grad_fn(cfg: ArchConfig, mesh):
    """The gradients of the mesh step: ``grad_fn(params, batch)`` with
    ``params`` a module of DTensor parameters and the global ``batch``
    returns ``(loss, metrics, grads, gnorm)``: this data rank's share of
    the loss and metrics, each leaf's gradient of the global mean loss
    as a DTensor under its optimizer state's placements (summed over the
    data axes in the gradient's own dtype, as the plain step keeps its
    gradients), and the global norm over every block, each counted once.
    With ``cfg.grad_accum`` > 1 each rank accumulates its blocks'
    gradients in fp32."""
    check_mesh(cfg, mesh)
    model = Model(cfg)
    accum = max(1, cfg.grad_accum)

    def grad_fn(params, batch):
        named = dict(params.named_parameters())
        dev = next(iter(named.values())).to_local().device
        lb = {k: v.to(dev) for k, v in local_batch(mesh, batch).items()}
        tp = make_tensor_parallel(cfg, mesh, lb["tokens"].shape[1])
        gpl = {n: grad_placements(mesh, p.placements)
               for n, p in named.items()}
        ospecs = shd.named_opt_specs(mesh, cfg, named)
        micro = [lb] if accum == 1 else [
            {k: v[i] for k, v in microbatches(lb, accum).items()}
            for i in range(accum)]
        acc, lsum, metrics = {}, 0.0, {}
        with tensor_parallel(tp):
            for mb in micro:
                local = {n: p.to_local(grad_placements=gpl[n])
                         for n, p in named.items()}
                with local_params(params, local):
                    loss, metrics = model.loss(params, mb)
                    grads = torch.autograd.grad(loss, list(named.values()))
                del local
                for n, g in zip(named, grads):
                    g = g.to_local()
                    acc[n] = g if accum == 1 else (
                        acc[n] + g.float() if n in acc else g.float())
                del grads
                lsum = lsum + loss.detach()
        loss = lsum / accum
        metrics = {} if accum > 1 else {k: v.detach()
                                        for k, v in metrics.items()}
        # each leaf onto its optimizer slice, one at a time; the squares
        # summed as ``global_norm`` sums them (on one rank, its bits)
        grads, parts = {}, []
        for n, p in named.items():
            g = acc.pop(n)
            if accum > 1:
                g = g / accum
            pl = shd.placements(ospecs[n], mesh)
            grads[n] = shd.as_dtensor(g, mesh, gpl[n], p.shape).redistribute(
                mesh, pl)
            del g
            if _count_once(mesh, pl):
                parts.append(torch.sum(grads[n].to_local().float() ** 2))
        sq = (torch.sum(torch.stack(parts)) if parts
              else torch.zeros((), dtype=torch.float32, device=dev))
        dist.all_reduce(sq)
        return loss, metrics, grads, torch.sqrt(sq)

    return grad_fn


def build_mesh_step_fn(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh):
    """The train step on ``mesh``: ``step_fn(params, opt_state, batch)``
    with ``params`` a module of DTensor parameters (``shard_params``),
    ``opt_state`` from :func:`init_sharded_opt_state` and the global
    ``batch``; it updates ``params`` in place and returns ``(params,
    new_opt_state, loss, metrics)``, the loss the global mean (on every
    rank). The gradients come from :func:`build_mesh_grad_fn`, and
    ``apply_updates`` widens and clips each as it goes."""
    grad_fn = build_mesh_grad_fn(cfg, mesh)
    data_axes = [a for a in mesh.mesh_dim_names if a != "model"]

    def step_fn(params, opt_state, batch):
        named = dict(params.named_parameters())
        with torch.profiler.record_function("train_step.grads"):
            loss, metrics, grads, gnorm = grad_fn(params, batch)
        with torch.profiler.record_function("train_step.optimizer"):
            opl = {n: t.placements for n, t in opt_state["master"].items()}
            state = {part: {n: t.to_local()
                            for n, t in opt_state[part].items()}
                     for part in ("master", "m", "v")}
            state["step"] = opt_state["step"]
            new_params, new_state = apply_updates(
                opt_cfg, {n: p.to_local() for n, p in named.items()},
                {n: g.to_local() for n, g in grads.items()}, state,
                gnorm=gnorm)
            del grads, state
            with torch.no_grad():
                for n, p in named.items():
                    new = shd.as_dtensor(new_params.pop(n), mesh, opl[n],
                                         p.shape)
                    p.to_local().copy_(new.redistribute(
                        mesh, p.placements).to_local())
            for part in ("master", "m", "v"):
                new_state[part] = {
                    n: shd.as_dtensor(t, mesh, opl[n], named[n].shape)
                    for n, t in new_state[part].items()}
        # the loss and metrics: every data rank's share summed
        out = [loss] + [metrics[k] for k in sorted(metrics)]
        for i, t in enumerate(out):
            t = t.detach().clone()
            for a in data_axes:
                dist.all_reduce(t, group=mesh.get_group(a))
            out[i] = t
        loss = out[0]
        metrics = dict(zip(sorted(metrics), out[1:]))
        if "moe_aux" in metrics:            # a mean over the data ranks
            n_data = int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                                  for a in data_axes]))
            metrics["moe_aux"] = metrics["moe_aux"] / n_data
        return params, new_state, loss, metrics

    return step_fn


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh=None):
    """The train step: :func:`build_step_fn` without a mesh, the per-rank
    program of :func:`build_mesh_step_fn` on one."""
    if mesh is None:
        return build_step_fn(cfg, opt_cfg)
    return build_mesh_step_fn(cfg, opt_cfg, mesh)


def _leaves(tree):
    """The leaves of a nested mapping in the reference's order (a JAX
    pytree flattens a dict by sorted keys), or of a module in
    ``named_parameters`` order."""
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def plan_update_multistream(params, n_clusters: Optional[int] = None,
                            pipeline: bool = True,
                            device=None) -> Dict[str, Any]:
    """Schedule the optimizer update as a multi-cluster descriptor program
    (the reference's plan, the same numbers for the same leaf shapes).

    Each parameter tensor's update is a dependent two-command chain over
    its own address range: the grad stream is preconditioned elementwise
    into a scratch window (MUL with the per-element preconditioner), then
    folded into the params (AXPY) — a RAW dependency through the scratch
    buffer. Tensors stay independent of each other, so the cluster
    scheduler load-balances the per-tensor chains over the mesh and
    prices the critical path vs. serial execution. With ``pipeline=True``
    the plan also level-izes the chains into a stage pipeline and reports
    its projected speedup under ``"pipeline"``.

    ``params``: a tree of arrays or tensors (a mapping, leaves in sorted
    key order as the reference flattens it; the Trainer passes the
    reference's layout) or a module. Only shapes are read, so meta
    tensors do; nothing is launched. ``n_clusters=None`` means one per
    device of ``device`` (1 for the CPU)."""
    from repro_torch.core import Program
    from repro_torch.core.multistream import (ClusterScheduler,
                                              StageSchedule, device_count)
    prog = Program()
    for ti, leaf in enumerate(_leaves(params)):
        n = int(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1
        g = prog.buffer((n,), name=f"grad{ti}")
        pre = prog.buffer((n,), name=f"precond{ti}")
        w = prog.buffer((n,), name=f"param{ti}")
        scratch = prog.mul(g, pre)            # scratch = grad * precond
        prog.axpy(-1.0, scratch, w, out=w)    # param += -lr * scratch
    descs = prog.descriptors
    if n_clusters is None:
        n_clusters = max(1, device_count(device))
    sched = ClusterScheduler(descs, n_clusters=n_clusters)
    plan = {"n_substreams": len(sched.substreams),
            "n_clusters": sched.n_clusters,
            "assignment": list(sched.assignment),
            "critical_path_s": max(sched.cluster_times(), default=0.0),
            "serial_time_s": sum(sched.costs),
            "model_speedup": sched.model_speedup()}
    if pipeline:
        ss = StageSchedule(sched.graph, n_clusters=n_clusters)
        plan["pipeline"] = {
            "n_nodes": len(ss.nodes),
            "n_stages": len(ss.stages),
            "handoff_bytes": ss.stats["handoff_bytes"],
            "handoff_bytes_cross": ss.stats["handoff_bytes_cross"],
            "pipeline_time_s": ss.model_time(),
            "model_speedup": ss.model_speedup()}
    return plan


class Trainer:
    """The fault-tolerant train loop on one device, or with ``mesh`` (a
    ``DeviceMesh`` over the process group, :mod:`repro_torch.launch.mesh`)
    every rank's part of the loop on it: the same seed's parameters on
    every rank, sharded; the same global batches, each rank taking its
    block; checkpoints gathered to the reference's stacked layout and
    written by rank 0, restored on any mesh (``reshard_checkpoint``)."""

    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainConfig, mesh=None, device="cuda"):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.step_fn = make_train_step(cfg, opt_cfg, mesh)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh with device "
                             f"{device}")
        self.model = Model(cfg)
        self.writer = mesh is None or dist.get_rank() == 0
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len,
                                seed=tcfg.seed)
        self._stop_requested = False
        self.stats: Dict[str, Any] = {"straggler_events": 0, "bad_steps": 0,
                                      "resumed_from": None}

    def _sigterm(self, *_):
        self._stop_requested = True

    def _state_tree(self, params, opt_state, data_step: int,
                    device=None) -> Optional[Dict[str, Any]]:
        """``{params, opt, data_step}`` in the reference's stacked layout,
        the leaves moved to ``device`` if given. On a mesh every rank
        gathers each DTensor whole (a collective), and only the writer
        keeps it: the other ranks drop each leaf as it comes and return
        None."""
        def leaf(t):
            t = t.detach()
            if isinstance(t, DTensor):
                t = t.full_tensor()
            return t if device is None else t.to(device)

        if not self.writer:
            for named in (dict(params.named_parameters()),
                          *(opt_state[k] for k in ("master", "m", "v"))):
                for t in named.values():
                    t.detach().full_tensor()
            return None

        def tree(named):
            return to_reference({n: leaf(t) for n, t in named.items()},
                                self.cfg)
        return {"params": tree(dict(params.named_parameters())),
                "opt": {"master": tree(opt_state["master"]),
                        "m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                        "step": torch.tensor(opt_state["step"],
                                             dtype=torch.int32)},
                "data_step": torch.tensor(data_step, dtype=torch.int32)}

    def _restore(self, params, opt_state):
        if self.mesh is not None:
            return self._restore_sharded(params, opt_state)
        like = self._state_tree(params, opt_state, 0, device="meta")
        restored, ck_step = self.ckpt.restore(like)
        named = dict(params.named_parameters())
        with torch.no_grad():
            for n, t in named_from_reference(restored["params"], named,
                                             self.cfg).items():
                named[n].copy_(t)
        for part in ("master", "m", "v"):
            opt_state[part] = {
                n: t.to(self.device) for n, t in named_from_reference(
                    restored["opt"][part], named, self.cfg).items()}
        opt_state["step"] = int(restored["opt"]["step"])
        self.data.state.step = int(restored["data_step"])
        self.stats["resumed_from"] = int(ck_step)
        return int(ck_step)

    def _restore_sharded(self, params, opt_state):
        """The newest checkpoint, each rank reading its blocks of the
        stacked leaves (``reshard_checkpoint``) under the placements of
        this mesh's parameters and optimizer state."""
        mesh, cfg = self.mesh, self.cfg
        named = dict(params.named_parameters())

        def like(tensors):
            """The stacked tree of empty DTensors: each stack once, its
            leading layer axis whole, the layers' placements after it."""
            tree: Dict[str, Any] = {}
            depth: Dict[tuple, int] = {}
            for n in tensors:
                path, idx = reference_path(n, cfg)
                if idx is not None:
                    depth[path] = max(depth.get(path, 0), idx + 1)
            for n, t in tensors.items():
                path, idx = reference_path(n, cfg)
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                if path[-1] in node:
                    continue
                shape, pl = tuple(t.shape), list(t.placements)
                if idx is not None:
                    shape = (depth[path], *shape)
                    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                          for p in pl]
                node[path[-1]] = torch.distributed.tensor.empty(
                    shape, dtype=t.dtype, device_mesh=mesh, placements=pl)
            return tree
        stacked = {"params": like(named),
                   "opt": {part: like(opt_state[part])
                           for part in ("master", "m", "v")},
                   "data_step": torch.zeros((), dtype=torch.int32)}
        stacked["opt"]["step"] = torch.zeros((), dtype=torch.int32)
        step = self.ckpt.latest()
        restored = reshard_checkpoint(self.ckpt._step_dir(step), stacked)

        def unstack(tree_, tensors):
            out = {}
            for n, t in tensors.items():
                path, idx = reference_path(n, cfg)
                leaf = tree_
                for key in path:
                    leaf = leaf[key]
                loc = leaf.to_local()
                loc = loc if idx is None else loc[idx].contiguous()
                out[n] = shd.as_dtensor(loc, mesh, t.placements, t.shape)
            return out
        with torch.no_grad():
            for n, t in unstack(restored["params"], named).items():
                named[n].to_local().copy_(t.to_local())
        for part in ("master", "m", "v"):
            opt_state[part] = unstack(restored["opt"][part], opt_state[part])
        opt_state["step"] = int(restored["opt"]["step"])
        self.data.state.step = int(restored["data_step"])
        self.stats["resumed_from"] = int(step)
        return int(step)

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        tcfg = self.tcfg
        steps = steps or tcfg.steps
        mesh = self.mesh
        params = self.model.init(tcfg.seed, device=self.device,
                                 trainable=True)
        if mesh is None:
            opt_state = init_opt_state(dict(params.named_parameters()))
        else:
            shd.shard_params(params, mesh, shd.named_param_specs(
                self.cfg, dict(params.named_parameters())))
            opt_state = init_sharded_opt_state(mesh, self.cfg, params)
        start = 0
        if tcfg.multistream_plan:
            # the reference's leaf order: its stacked tree, shapes only
            tree = to_reference({n: torch.empty(p.shape, device="meta")
                                 for n, p in params.named_parameters()},
                                self.cfg)
            self.stats["multistream"] = plan_update_multistream(
                tree, n_clusters=None if mesh is None else mesh.size(),
                device=self.device)
        if tcfg.resume == "auto" and self.ckpt.latest() is not None:
            start = self._restore(params, opt_state)

        old_handler = signal.signal(signal.SIGTERM, self._sigterm)
        ema, emvar = None, 0.0
        consecutive_bad = 0
        losses = []
        it = iter(self.data)
        try:
            for step in range(start, steps):
                batch = next(it)
                if mesh is None:         # the mesh step takes its block
                    batch = {k: v.to(self.device) for k, v in batch.items()}
                t0 = time.perf_counter()
                params, opt_state, loss, metrics = self.step_fn(
                    params, opt_state, batch)
                loss = float(loss)
                dt = time.perf_counter() - t0

                # straggler watchdog (per-step wall time z-score);
                # the first step builds the kernels and is excluded
                if step == start:
                    pass
                elif ema is None:
                    ema = dt
                else:
                    if emvar > 0 and dt > ema + tcfg.straggler_z * np.sqrt(
                            emvar):
                        self.stats["straggler_events"] += 1
                    emvar = 0.9 * emvar + 0.1 * (dt - ema) ** 2
                    ema = 0.9 * ema + 0.1 * dt

                # NaN fuse
                if not np.isfinite(loss):
                    self.stats["bad_steps"] += 1
                    consecutive_bad += 1
                    if consecutive_bad > tcfg.max_bad_steps:
                        raise FloatingPointError(
                            f"{consecutive_bad} consecutive non-finite steps")
                else:
                    consecutive_bad = 0
                    losses.append(loss)

                if tcfg.log_every and (step + 1) % tcfg.log_every == 0:
                    print(f"step {step + 1:5d} loss {loss:.4f} "
                          f"{dt * 1e3:.0f} ms", flush=True)
                if ((step + 1) % tcfg.ckpt_every == 0
                        or self._stop_requested or step + 1 == steps):
                    tree = self._state_tree(
                        params, opt_state, self.data.state.step,
                        device=None if mesh is None else "cpu")
                    if self.writer:
                        self.ckpt.save(step + 1, tree)
                    del tree
                if self._stop_requested:
                    print("preemption requested: saved and stopping",
                          flush=True)
                    break
        finally:
            self.data.close()
            self.ckpt.wait()
            signal.signal(signal.SIGTERM, old_handler)
        if mesh is not None:
            dist.barrier()               # the checkpoint is on disk
        return {"losses": losses, "params": params, "opt": opt_state,
                **self.stats}

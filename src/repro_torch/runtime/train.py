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
``stats["multistream"]``; the plan launches nothing. The mesh (ROADMAP
slice G) is not ported: ``mesh`` must be None; the mesh's gradient
compression waits with it.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.models import ArchConfig, Model
from repro_torch.models.convert import named_from_reference, to_reference
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
    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainConfig, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("training on a mesh is not ported yet "
                                      "(ROADMAP queue 1, slice G)")
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = torch.device(device)
        self.model = Model(cfg)
        self.step_fn = build_step_fn(cfg, opt_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len,
                                seed=tcfg.seed)
        self._stop_requested = False
        self.stats: Dict[str, Any] = {"straggler_events": 0, "bad_steps": 0,
                                      "resumed_from": None}

    def _sigterm(self, *_):
        self._stop_requested = True

    def _state_tree(self, params, opt_state, data_step: int,
                    device=None) -> Dict[str, Any]:
        """``{params, opt, data_step}`` in the reference's stacked layout,
        the leaves moved to ``device`` if given."""
        def tree(named):
            return to_reference({n: t.detach() if device is None else
                                 t.detach().to(device)
                                 for n, t in named.items()}, self.cfg)
        return {"params": tree(dict(params.named_parameters())),
                "opt": {"master": tree(opt_state["master"]),
                        "m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                        "step": torch.tensor(opt_state["step"],
                                             dtype=torch.int32)},
                "data_step": torch.tensor(data_step, dtype=torch.int32)}

    def _restore(self, params, opt_state):
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

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        tcfg = self.tcfg
        steps = steps or tcfg.steps
        params = self.model.init(tcfg.seed, device=self.device,
                                 trainable=True)
        opt_state = init_opt_state(dict(params.named_parameters()))
        start = 0
        if tcfg.multistream_plan:
            # the reference's leaf order: its stacked tree, shapes only
            tree = self._state_tree(params, opt_state, 0,
                                    device="meta")["params"]
            self.stats["multistream"] = plan_update_multistream(
                tree, device=self.device)
        if tcfg.resume == "auto" and self.ckpt.latest() is not None:
            start = self._restore(params, opt_state)

        old_handler = signal.signal(signal.SIGTERM, self._sigterm)
        ema, emvar = None, 0.0
        consecutive_bad = 0
        losses = []
        it = iter(self.data)
        try:
            for step in range(start, steps):
                batch = {k: v.to(self.device) for k, v in next(it).items()}
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
                    self.ckpt.save(step + 1, self._state_tree(
                        params, opt_state, self.data.state.step))
                if self._stop_requested:
                    print("preemption requested: saved and stopping",
                          flush=True)
                    break
        finally:
            self.data.close()
            self.ckpt.wait()
            signal.signal(signal.SIGTERM, old_handler)
        return {"losses": losses, "params": params, "opt": opt_state,
                **self.stats}

"""Dry run on the meta device: trace every (arch x shape) cell's step
once, with no card and no memory, and count its work.

The counterpart of ``repro.launch.dryrun``. Where the reference lowers
and compiles each cell with XLA over ShapeDtypeStructs, this module runs
the port's eager step once on meta tensors (``configs.shapes``): the
``ops`` wrappers take their meta route, which checks and plans each call
as the card would and tallies it (``ops.DRY``), and every other aten op
passes through two counters. For each cell it records:

  * the kernels' calls per family (as ``ops.LAUNCHES`` would count them
    on the card), their tensor-product flops and their bytes;
  * the tensor-product flops of the aten ops outside the kernels
    (``torch.utils.flop_counter.FlopCounterMode``);
  * the bytes of every aten op, each input read once and each output
    written once (views and aliases move none; an in-place op counts what
    it writes);
  * the arguments' bytes (params, optimizer state, batch or cache), the
    outputs', and the peak of live bytes during the step, which decides
    whether the cell fits one card (``HBM_BYTES``);
  * the collectives the step issues, by the reference's five kinds, with
    their wire bytes per device (:func:`wire_bytes`).

On ``card`` the step is the single-card one (``build_step_fn``,
``Model.prefill``, ``Model.decode``) and issues no collective. On the
production meshes, ``single`` (16, 16) over ("data", "model") and
``multi`` (2, 16, 16) over ("pod", "data", "model"), the step is one
rank's program of the port's mesh steps (``build_mesh_step_fn``,
``build_mesh_prefill_fn``, ``build_mesh_decode_fn``), traced under
PyTorch's fake process group (``init_process_group("fake")``: every
collective returns at once and moves nothing) on a ``DeviceMesh("cpu")``
whose DTensors hold meta local tensors. Where the reference's SPMD
program is the same on every device, a port rank's work is not (uneven
head blocks, a rank without heads, context-parallel key blocks), so a
record is one rank's (``rank``, default 0). The counts are that rank's:

  * DTensor ops are not counted at their global shapes: both counters
    defer to DTensor (``NotImplemented``), whose dispatch runs the local
    ops, and those come back to the counters; the fake-tensor ops of
    DTensor's sharding propagation are not counted at all.
  * A collective is counted at its output's bytes (the reference takes
    the HLO result's shape) over its group's size S, by the reference's
    ring model (``parse_collectives``). Two decisions differ from it: a
    group of one rank moves nothing (XLA never emits such a collective,
    the port's code issues some, the norm's all-reduce on a 1-rank
    world: the card record keeps its 0, where the reference's
    ``max(group, 2)`` would charge it); and a collective's bytes stay out
    of ``aten_bytes``: the memory term is HBM traffic, the collective
    term has its own rate. ``wait_tensor`` moves nothing.

The record keeps the reference's keys (``production`` with ``flops``,
``bytes_accessed``, ``memory`` and ``collectives``; ``delta_total``;
``n_periods``; ``mesh`` and ``n_devices``), so ``perfmodel.gpu_roofline``
reads it as the reference's roofline reads its own, and adds
``launches``, ``fits`` and, on a mesh, ``rank``. The reference's delta
method (unrolled 1- and 2-period variants, ``total = F1 + (n - 1)(F2 -
F1)``) corrects XLA's once-per-loop-body cost analysis; the eager trace
is already unrolled, so here ``delta_total`` must equal the direct
count, collectives included: a check on the accounting.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k \\
      --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --mesh both --skip-delta \\
      --out results/dryrun_torch_mesh
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import time
import weakref
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

#: device memory of one H100 SXM5 80GB (data sheet): a cell fits if its
#: peak of live bytes is at most this
HBM_BYTES = 80e9
MESHES = ("card", "single", "multi", "both")
#: the production meshes: (16, 16) and (2, 16, 16), 256 and 512 ranks
PRODUCTION = {"single": (16, 16), "multi": (2, 16, 16)}
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


#: factories of uninitialised memory: they allocate and move nothing
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}

#: the port's collective ops (``namespace.name``) under the reference's
#: five kinds
_KINDS = {
    "all-gather": (
        "_c10d_functional.all_gather_into_tensor",
        "_c10d_functional.all_gather_into_tensor_coalesced",
        "_c10d_functional_autograd.all_gather_into_tensor",
        "c10d._allgather_base_", "c10d.allgather_",
        "c10d.allgather_into_tensor_coalesced_"),
    "reduce-scatter": (
        "_c10d_functional.reduce_scatter_tensor",
        "_c10d_functional.reduce_scatter_tensor_coalesced",
        "_c10d_functional_autograd.reduce_scatter_tensor",
        "c10d._reduce_scatter_base_", "c10d.reduce_scatter_",
        "c10d.reduce_scatter_tensor_coalesced_"),
    "all-reduce": (
        "_c10d_functional.all_reduce", "_c10d_functional.all_reduce_",
        "_c10d_functional.all_reduce_coalesced",
        "_c10d_functional.all_reduce_coalesced_", "c10d.allreduce_",
        "c10d.allreduce_coalesced_"),
    "all-to-all": (
        "_c10d_functional.all_to_all_single",
        "_c10d_functional_autograd.all_to_all_single",
        "c10d.alltoall_base_", "c10d.alltoall_"),
    "collective-permute": ("c10d.send",),
}
COLLECTIVES = {op: kind for kind, names in _KINDS.items() for op in names}
_COMM_NAMESPACES = {"c10d", "_c10d_functional", "_c10d_functional_autograd"}
#: communication ops that move no bytes of their own (a receive is
#: counted at its send)
_NO_WIRE = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
            "monitored_barrier_", "recv_", "recv_any_source_"}


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` whose output
    has ``nbytes`` over a group of ``group`` ranks, by the reference's
    ring model (``parse_collectives``): all-gather out (S-1)/S,
    reduce-scatter out (S-1), all-reduce 2 bytes (S-1)/S, all-to-all
    bytes (S-1)/S, collective-permute bytes. A group of one rank moves
    nothing."""
    if group <= 1:
        return 0.0
    s = group
    if kind == "all-gather":
        return nbytes * (s - 1) / s
    if kind == "reduce-scatter":
        return nbytes * (s - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (s - 1) / s
    if kind == "all-to-all":
        return nbytes * (s - 1) / s
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_fake_mode() -> bool:
    """True inside a FakeTensorMode: DTensor's sharding propagation, which
    runs each op once at its global shapes to learn the output's."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _arg_values(func, args, kwargs):
    """(schema argument, value) of every argument of a call."""
    for i, arg in enumerate(func._schema.arguments):
        yield arg, (args[i] if i < len(args) else kwargs.get(arg.name))


def _process_group(func, args, kwargs):
    """The process group a c10d or functional collective runs over."""
    from torch.distributed import distributed_c10d as c10d
    from torch._C._distributed_c10d import ProcessGroup
    for arg, val in _arg_values(func, args, kwargs):
        if arg.name == "group_name" and isinstance(val, str):
            return c10d._resolve_process_group(val)
        if isinstance(val, torch.ScriptObject) and \
                val._type().name() == "ProcessGroup":
            return ProcessGroup.unbox(val)
    raise ValueError(f"{func}: no process group among its arguments")


class ByteCounter(TorchDispatchMode):
    """Counts the bytes every aten op moves, the peak of live bytes made
    during the trace, and the collectives.

    Bytes: an op reads each tensor input once and writes each output
    once; a view (every output aliases an input, nothing written) moves
    none, an in-place or ``out=`` op writes what it mutates, and a
    factory of uninitialised memory (``empty``) moves none.

    Live bytes: each new storage an op makes is live until it is freed:
    a finalizer on its Python object (which PyTorch keeps as long as the
    storage lives, views and autograd's saved tensors included) takes it
    off again. The peak is taken at every allocation.

    Collectives (``c10d`` and ``_c10d_functional`` ops): each is logged
    as ``(kind, dtype, numel, group size, axis)`` of its output (an
    in-place one's first argument), ``axis`` the name that ``groups``
    gives its process group ("other" where it names none); their bytes
    stay out of :attr:`bytes`, a functional one's output is live.

    An op on DTensors is left to DTensor (``NotImplemented``), whose
    dispatch runs the local ops through this mode again; ops inside a
    FakeTensorMode run uncounted, with every mode below this one off."""

    def __init__(self, groups: Dict[str, str] | None = None):
        super().__init__()
        self.bytes = 0
        self.peak = self.live = 0
        self.groups = groups or {}
        self.collectives = []

    def _free(self, n: int) -> None:
        self.live -= n

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        n = st.nbytes()
        if not n:
            return
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n).atexit = False

    def _communicate(self, func, args, kwargs, out) -> None:
        name = func._schema.name.replace("::", ".")
        kind = COLLECTIVES.get(name)
        if kind is None:
            if func._schema.name.split("::")[1] in _NO_WIRE:
                return
            raise NotImplementedError(f"the dry run has no wire model for "
                                      f"{name}")
        functional = func.namespace != "c10d"
        outs = [t for t in tree_leaves(out if functional else args[0])
                if isinstance(t, torch.Tensor)]
        pg = _process_group(func, args, kwargs)
        for t in outs:
            self.collectives.append((kind, str(t.dtype).split(".")[-1],
                                     t.numel(), pg.size(),
                                     self.groups.get(pg.group_name,
                                                     "other")))
            if functional:
                self._alloc(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _in_fake_mode():
            with _disable_current_modes():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.namespace in _COMM_NAMESPACES:
            self._communicate(func, args, kwargs, out)
            return out
        schema = func._schema
        written = set()
        for arg, val in _arg_values(func, args, kwargs):
            if arg.alias_info is not None and arg.alias_info.is_write:
                written.update(id(t) for t in tree_leaves(val)
                               if isinstance(t, torch.Tensor))
        views = all(r.alias_info is not None for r in schema.returns)
        if views and not written:
            return out                           # a view or an alias
        fresh = func.overloadpacket.__name__ in _UNINITIALISED
        # each input once: read, or written where the op mutates it
        moved = 0 if fresh else sum(
            _tensor_bytes(t) for t in {
                id(t): t for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}.values())
        outs = tree_leaves(out)
        rets = schema.returns
        if len(rets) == 1:             # one return, or one list of tensors
            rets = rets * len(outs)
        for r, t in zip(rets, outs):
            if isinstance(t, torch.Tensor) and r.alias_info is None:
                moved += 0 if fresh else _tensor_bytes(t)
                self._alloc(t)
        self.bytes += moved
        return out


def collective_summary(log) -> Dict[str, Any]:
    """The record's ``collectives`` from a :class:`ByteCounter`'s log:
    ``counts`` and ``wire_bytes_per_device`` by kind, the wire bytes by
    mesh axis (``wire_bytes_by_axis``), their total
    (``total_wire_bytes_per_device``), and ``ops``: each distinct
    ``[kind, dtype, numel, group size, axis]`` with its count."""
    counts: Dict[str, int] = {}
    by_kind: Dict[str, float] = {}
    by_axis: Dict[str, float] = {}
    ops: Dict[tuple, int] = {}
    for kind, dtype, numel, group, axis in log:
        w = wire_bytes(kind, numel * getattr(torch, dtype).itemsize, group)
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + w
        by_axis[axis] = by_axis.get(axis, 0.0) + w
        key = (kind, dtype, numel, group, axis)
        ops[key] = ops.get(key, 0) + 1
    return {"counts": counts, "wire_bytes_per_device": by_kind,
            "wire_bytes_by_axis": by_axis,
            "total_wire_bytes_per_device": sum(by_kind.values()),
            "ops": [[*k, n] for k, n in sorted(ops.items())]}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank; any other tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _unique_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` use (a
    DTensor's block on this rank)."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _storages(tree) -> set:
    return {_local(t).untyped_storage()._cdata for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def mesh_groups(mesh) -> Dict[str, str]:
    """``{process group name: axis}`` of a mesh's groups: each dimension's
    by its name, the default group's by every name joined with "+"."""
    import torch.distributed as dist
    names = mesh.mesh_dim_names
    out = {dist.group.WORLD.group_name: "+".join(names)}
    out.update({mesh.get_group(a).group_name: a for a in names})
    return out


def trace(fn, *args, mesh=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once on meta tensors under the counters. ``args``
    (params, optimizer state, batch or cache; modules count their
    parameters; a DTensor counts its block on this rank) are the step's
    arguments; ``mesh`` names the axes of the collectives' groups.
    Returns the counts: kernel calls by family (``launches``), flops and
    bytes (the kernels' and the other aten ops', and their sums),
    ``memory`` (argument, output, alias and temporary bytes, and the peak
    of live bytes) and ``collectives`` (:func:`collective_summary`)."""
    from repro_torch.kernels import ops

    leaves = [list(a.parameters()) if isinstance(a, torch.nn.Module) else a
              for a in args]
    arg_bytes = _unique_bytes(leaves)
    arg_st = _storages(leaves)
    ops.reset_dry()
    counter = ByteCounter(mesh_groups(mesh) if mesh is not None else None)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, counter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    tally = ops.dry()
    out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    alias = [t for t in out_leaves
             if _local(t).untyped_storage()._cdata in arg_st]
    fresh = [t for t in out_leaves
             if _local(t).untyped_storage()._cdata not in arg_st]
    k_flops, k_bytes = (sum(tally[p].values()) for p in ("flops", "bytes"))
    a_flops = int(flops.get_total_flops())
    return {
        "trace_s": round(trace_s, 3),
        "launches": {k: v for k, v in tally["calls"].items() if v},
        "kernel_flops": k_flops, "aten_flops": a_flops,
        "flops": k_flops + a_flops,
        "kernel_bytes": k_bytes, "aten_bytes": counter.bytes,
        "bytes_accessed": k_bytes + counter.bytes,
        "kernels": {f: {"calls": tally["calls"][f],
                        "flops": tally["flops"][f],
                        "bytes": tally["bytes"][f]}
                    for f, n in tally["calls"].items() if n},
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": _unique_bytes(fresh),
                   "alias_bytes": _unique_bytes(alias),
                   "temp_bytes": counter.peak,
                   "peak_bytes": arg_bytes + counter.peak},
        "collectives": collective_summary(counter.collectives),
    }


def count_calls(fn, *args) -> Dict[str, int]:
    """The kernel calls ``fn(*args)`` makes on meta tensors, by family,
    without the byte and flop counters (a cheaper pass where only the
    calls are wanted)."""
    from repro_torch.kernels import ops
    ops.reset_dry()
    fn(*args)
    return {k: v for k, v in ops.dry()["calls"].items() if v}


# ----------------------------------------------------------------------
# The steps
# ----------------------------------------------------------------------
def train_step(cfg, b: int, s: int, opt_cfg=None):
    """(fn, args) of one ``build_step_fn`` step (AdamW; ``cfg.grad_accum``
    microbatches) on meta params, optimizer state and a (b, s) batch."""
    from repro_torch.configs.shapes import batch_specs
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime.train import build_step_fn

    params = Model(cfg).init(0, device="meta", trainable=True)
    opt = init_opt_state(dict(params.named_parameters()))
    raw = build_step_fn(cfg, opt_cfg or AdamWConfig())

    def step(params, opt_state, batch):
        _, new_o, loss, _ = raw(params, opt_state, batch)
        return new_o, loss

    return step, (params, opt, batch_specs(cfg, b, s))


def prefill_step(cfg, b: int, s: int, cache_len: int | None = None,
                 batch: Dict[str, Any] | None = None):
    """(fn, args) of ``Model.prefill`` (under inference mode) on a (b, s)
    batch (``batch_specs``, or the given one) into a cache of
    ``cache_len`` slots (default s)."""
    from repro_torch.configs.shapes import batch_specs
    from repro_torch.models import Model

    model = Model(cfg)
    params = model.init(0, device="meta")

    def step(params, batch):
        with torch.inference_mode():
            logits, cache, _ = model.prefill(params, batch,
                                             cache_len=cache_len)
        return logits, cache

    return step, (params, batch if batch is not None
                  else batch_specs(cfg, b, s))


def decode_step(cfg, b: int, cache_len: int, fill: int,
                absorbed_mla: bool | None = None):
    """(fn, args) of one ``Model.decode`` step (under inference mode):
    (b, 1) tokens into a meta cache of ``cache_len`` slots at ``fill``,
    updated in place; MLA absorbed as ``cfg.mla_absorb`` unless given."""
    from repro_torch.configs.shapes import cache_specs
    from repro_torch.models import Model

    model = Model(cfg)
    params = model.init(0, device="meta")
    absorbed = cfg.mla_absorb if absorbed_mla is None else absorbed_mla

    def step(params, tokens, cache):
        with torch.inference_mode():
            return model.decode(params, tokens, cache, fill,
                                absorbed_mla=absorbed)

    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return step, (params, tokens, cache_specs(cfg, b, cache_len))


# ----------------------------------------------------------------------
# The steps on a mesh, one rank's program under the fake process group
# ----------------------------------------------------------------------
@contextlib.contextmanager
def fake_mesh(shape, rank: int = 0):
    """A ``DeviceMesh("cpu")`` of ``shape`` (``launch.mesh.make_mesh``:
    (data, model) or (pod, data, model)) as rank ``rank`` of PyTorch's
    fake process group, initialised here and destroyed on the way out,
    with the sequence-parallel residual set as the reference's step sets
    it (``set_activation_sharding``). A real process group refuses: the
    dry run never traces on top of NCCL or gloo; a fake one of the same
    size and rank is used as it is."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import set_activation_sharding
    world = math.prod(shape)
    mine = not dist.is_initialized()
    if mine:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    elif (dist.get_backend() != "fake" or dist.get_world_size() != world
          or dist.get_rank() != rank):
        raise RuntimeError(
            f"a {dist.get_backend()} process group of "
            f"{dist.get_world_size()} ranks is initialised: the dry run "
            f"traces rank {rank} of {world} under the fake process group "
            f"only, never on top of a real one")
    # DTensor's advice on two sequential collectives, once a redistribution
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        mesh = make_mesh(shape, device_type="cpu")
        set_activation_sharding(mesh, mesh.mesh_dim_names[:-1], "model")
        yield mesh
    finally:
        set_activation_sharding()
        log.setLevel(level)
        if mine:
            dist.destroy_process_group()


def _mesh_params(cfg, mesh, trainable: bool = False):
    """Meta params as DTensors under ``named_param_specs``, each rank
    holding its block."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import Model
    params = Model(cfg).init(0, device="meta", trainable=trainable)
    return shd.shard_params(params, mesh, shd.named_param_specs(
        cfg, dict(params.named_parameters())))


def _mesh_batch(mesh, batch: Dict[str, torch.Tensor]):
    """A global meta batch as DTensors under ``batch_specs``, each rank
    holding its block (as a loader hands it each rank)."""
    from repro_torch.distributed import sharding as shd
    specs = shd.batch_specs(mesh, dict(batch))
    return {k: shd.distribute(v, mesh, specs[k]) for k, v in batch.items()}


def mesh_train_step(cfg, mesh, b: int, s: int, opt_cfg=None):
    """(fn, args) of one ``build_mesh_step_fn`` step on ``mesh``: DTensor
    params under ``named_param_specs``, their ZeRO-1 state
    (``init_sharded_opt_state``), a (b, s) batch under ``batch_specs``."""
    from repro_torch.configs.shapes import batch_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (build_mesh_step_fn,
                                           init_sharded_opt_state)

    params = _mesh_params(cfg, mesh, trainable=True)
    opt = init_sharded_opt_state(mesh, cfg, params)
    raw = build_mesh_step_fn(cfg, opt_cfg or AdamWConfig(), mesh)

    def step(params, opt_state, batch):
        _, new_o, loss, _ = raw(params, opt_state, batch)
        return new_o, loss

    return step, (params, opt, _mesh_batch(mesh, batch_specs(cfg, b, s)))


def mesh_prefill_step(cfg, mesh, b: int, s: int):
    """(fn, args) of ``build_mesh_prefill_fn`` on ``mesh`` over a (b, s)
    batch into a cache of s slots."""
    from repro_torch.configs.shapes import batch_specs
    from repro_torch.runtime.serve import build_mesh_prefill_fn

    raw = build_mesh_prefill_fn(cfg, mesh)

    def step(params, batch):
        logits, cache, _ = raw(params, batch)
        return logits, cache

    return step, (_mesh_params(cfg, mesh),
                  _mesh_batch(mesh, batch_specs(cfg, b, s)))


def mesh_decode_step(cfg, mesh, b: int, cache_len: int, fill: int):
    """(fn, args) of one ``build_mesh_decode_fn`` step on ``mesh``: (b, 1)
    tokens into a ``mesh_cache`` of ``cache_len`` slots at ``fill``,
    updated in place; MLA as ``cfg.mla_absorb``."""
    from repro_torch.runtime.serve import build_mesh_decode_fn, mesh_cache

    raw = build_mesh_decode_fn(cfg, mesh)

    def step(params, tokens, cache):
        return raw(params, tokens, cache, fill)

    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return step, (_mesh_params(cfg, mesh),
                  _mesh_batch(mesh, {"tokens": tokens})["tokens"],
                  mesh_cache(cfg, mesh, b, cache_len, "meta"))


def _build_step(cfg, shape_name: str, mesh=None, size=None):
    """(fn, args) of the cell's step: ``build_step_fn`` with AdamW for
    ``train``, ``Model.prefill`` for ``prefill``, ``Model.decode`` on an
    in-place cache (the new token in its last slot) for ``decode``; on a
    ``mesh`` their mesh steps. ``size`` (b, s) in place of the shape's
    global batch and sequence."""
    from repro_torch.configs.shapes import SHAPES
    sh = SHAPES[shape_name]
    b, s = size or (sh.global_batch, sh.seq_len)
    if mesh is not None:
        if sh.kind == "train":
            return mesh_train_step(cfg, mesh, b, s)
        if sh.kind == "prefill":
            return mesh_prefill_step(cfg, mesh, b, s)
        return mesh_decode_step(cfg, mesh, b, s, s - 1)
    if sh.kind == "train":
        return train_step(cfg, b, s)
    if sh.kind == "prefill":
        return prefill_step(cfg, b, s)
    return decode_step(cfg, b, s, s - 1)


# ----------------------------------------------------------------------
# Cell runner
# ----------------------------------------------------------------------
def _unroll_cfg(cfg, n_periods: int):
    """The cell's config cut to ``n_periods`` periods of its layer stack.
    The reference also turns off ``grad_accum`` and
    ``prefill_microbatch`` there, because XLA's cost analysis counts a
    ``lax.scan`` / ``lax.map`` body once; an eager trace runs every
    microbatch, so they stay as the cell sets them."""
    from repro_torch.models import transformer
    if cfg.encoder_decoder:
        return cfg.scaled(unroll=True, n_layers=n_periods,
                          n_enc_layers=n_periods)
    P = transformer.period_len(cfg)
    return cfg.scaled(unroll=True, n_layers=n_periods * P)


def _n_periods(cfg):
    from repro_torch.models import transformer
    if cfg.encoder_decoder:
        return cfg.n_layers  # == n_enc_layers for whisper-medium
    return transformer.n_periods(cfg)


def _delta(u1: dict, u2: dict, n: int):
    """``u1 + (n - 1) (u2 - u1)`` of counts (ints, or dicts of ints)."""
    if isinstance(u1, dict):
        return {k: _delta(u1.get(k, 0), u2.get(k, 0), n)
                for k in sorted(set(u1) | set(u2))}
    return u1 + (n - 1) * (u2 - u1)


def mesh_name(shape) -> str:
    """``"16x16"`` of (16, 16)."""
    return "x".join(map(str, shape))


def record_mesh(mesh: str) -> str:
    """A record's ``mesh``: ``card``, or a production mesh's shape."""
    return mesh_name(PRODUCTION[mesh]) if mesh in PRODUCTION else mesh


def trace_cell(arch: str, shape_name: str, mesh: str,
               overrides: Dict[str, Any], skip_delta: bool = False,
               rank: int = 0) -> Dict[str, Any]:
    """The record of one cell on ``mesh``: ``card`` (one H100), or
    ``single`` / ``multi`` (rank ``rank``'s step on the (16, 16) or (2,
    16, 16) mesh)."""
    from repro_torch import configs

    if mesh not in ("card", *PRODUCTION):
        raise ValueError(f"mesh {mesh!r}: one of card, "
                         f"{', '.join(PRODUCTION)}")
    shape = PRODUCTION.get(mesh)
    cfg = configs.get(arch)
    ok, reason = configs.shape_applicable(cfg, shape_name)
    name = record_mesh(mesh)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "skipped": True, "reason": reason}
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": name,
                           "n_devices": 1, "skipped": False,
                           "overrides": overrides}
    if shape is not None:
        out.update(n_devices=math.prod(shape), rank=rank)
    out.update(count_cell(cfg.scaled(**overrides) if overrides else cfg,
                          shape_name, skip_delta, mesh_shape=shape,
                          rank=rank))
    return out


def count_cell(cfg, shape_name: str, skip_delta: bool = False,
               mesh_shape=None, rank: int = 0, size=None) -> Dict[str, Any]:
    """The counts of ``cfg``'s step at ``shape_name`` on one card, or of
    rank ``rank``'s on a fake mesh of ``mesh_shape`` (:func:`fake_mesh`):
    ``production`` (the direct count), ``launches``, ``fits`` (the rank's
    peak within ``HBM_BYTES``), and unless ``skip_delta`` the unrolled 1-
    and 2-period counts with the ``delta_total`` they give over
    ``n_periods``. ``size`` (b, s) in place of the shape's."""
    world = (fake_mesh(mesh_shape, rank) if mesh_shape is not None
             else contextlib.nullcontext())
    with world as mesh:
        def run(cfg_x):
            fn, args = _build_step(cfg_x, shape_name, mesh, size)
            return trace(fn, *args, mesh=mesh)

        prod = run(cfg)
        out = {"production": prod, "launches": prod["launches"],
               "fits": prod["memory"]["peak_bytes"] <= HBM_BYTES}
        if skip_delta:
            return out
        n = _n_periods(cfg)
        u1 = run(_unroll_cfg(cfg, 1))
        u2 = run(_unroll_cfg(cfg, 2))
        out["unroll1"], out["unroll2"] = u1, u2
        delta = {k: _delta(u1[k], u2[k], n)
                 for k in ("flops", "bytes_accessed", "launches")}
        delta["collective_wire_bytes_per_device"] = _delta(
            *(u["collectives"]["total_wire_bytes_per_device"]
              for u in (u1, u2)), n)
        out["delta_total"] = delta
        out["n_periods"] = n
    return out


def _parse_set(items) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if v in ("true", "True", "false", "False"):
            v = v in ("true", "True")
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPE_NAMES + [None])
    ap.add_argument("--mesh", default="card", choices=MESHES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-delta", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value (ints/floats/strs)")
    args = ap.parse_args(argv)
    overrides = _parse_set(args.set)

    from repro_torch import configs
    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_NAMES if (args.all or not args.shape) else [args.shape]
    meshes = list(PRODUCTION) if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{arch}_{shape}_{mesh}"
                if overrides:
                    tag += "_" + "_".join(f"{k}-{v}" for k, v
                                          in sorted(overrides.items()))
                path = os.path.join(args.out, tag + ".json")
                print(f"=== {tag}", flush=True)
                try:
                    rec = trace_cell(arch, shape, mesh, overrides,
                                     skip_delta=args.skip_delta)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": record_mesh(mesh), "error": str(e)[:2000]}
                    failures.append(tag)
                    print(f"    FAILED: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if "error" not in rec and not rec.get("skipped"):
                    p = rec["production"]
                    wire = p["collectives"]["total_wire_bytes_per_device"]
                    print(f"    trace {p['trace_s']}s  flops "
                          f"{p['flops']:.4g}  bytes "
                          f"{p['bytes_accessed']:.4g}  wire {wire:.4g}  "
                          f"peak {p['memory']['peak_bytes'] / 2**30:.2f} "
                          f"GiB  fits {rec['fits']}  launches "
                          f"{rec['launches']}", flush=True)
                elif rec.get("skipped"):
                    print(f"    SKIP: {rec['reason']}", flush=True)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()

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
    whether the cell fits one card (``HBM_BYTES``).

The record keeps the reference's keys (``production`` with ``flops``,
``bytes_accessed`` and ``memory``; ``delta_total``; ``n_periods``), so
``perfmodel.gpu_roofline`` reads it as the reference's roofline reads its
own, and adds ``launches`` and ``fits``. The reference's delta method
(unrolled 1- and 2-period variants, ``total = F1 + (n - 1)(F2 - F1)``)
corrects XLA's once-per-loop-body cost analysis; the eager trace is
already unrolled, so here ``delta_total`` must equal the direct count, a
check on the accounting. One card is the only mesh: ``single`` and
``multi`` wait for the rest of slice G (ROADMAP item 14b: a per-rank
trace of the mesh step), and with them the collectives, whose term is 0
on one card.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k \\
      --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

#: device memory of one H100 SXM5 80GB (data sheet): a cell fits if its
#: peak of live bytes is at most this
HBM_BYTES = 80e9
MESHES = ("card", "single", "multi")
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


#: factories of uninitialised memory: they allocate and move nothing
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Counts the bytes every aten op moves and the peak of live bytes
    made during the trace.

    Bytes: an op reads each tensor input once and writes each output
    once; a view (every output aliases an input, nothing written) moves
    none, an in-place or ``out=`` op writes what it mutates, and a
    factory of uninitialised memory (``empty``) moves none.

    Live bytes: each new storage an op makes is live until it is freed:
    a finalizer on its Python object (which PyTorch keeps as long as the
    storage lives, views and autograd's saved tensors included) takes it
    off again. The peak is taken at every allocation."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.peak = self.live = 0

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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        written = set()
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(arg.name)
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


def _unique_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` use."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def trace(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once on meta tensors under the counters. ``args``
    (params, optimizer state, batch or cache; modules count their
    parameters) are the step's arguments. Returns the counts: kernel
    calls by family (``launches``), flops and bytes (the kernels' and the
    other aten ops', and their sums), and ``memory`` (argument, output,
    alias and temporary bytes, and the peak of live bytes)."""
    from repro_torch.kernels import ops

    leaves = [list(a.parameters()) if isinstance(a, torch.nn.Module) else a
              for a in args]
    arg_bytes = _unique_bytes(leaves)
    arg_st = _storages(leaves)
    ops.reset_dry()
    counter = ByteCounter()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, counter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    tally = ops.dry()
    out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    alias = [t for t in out_leaves if t.untyped_storage()._cdata in arg_st]
    fresh = [t for t in out_leaves if t.untyped_storage()._cdata not in arg_st]
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


def _build_step(cfg, shape_name: str):
    """(fn, args) of the cell's step: ``build_step_fn`` with AdamW for
    ``train``, ``Model.prefill`` for ``prefill``, ``Model.decode`` on an
    in-place cache (the new token in its last slot) for ``decode``."""
    from repro_torch.configs.shapes import SHAPES
    sh = SHAPES[shape_name]
    b, s = sh.global_batch, sh.seq_len
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


def _check_mesh(mesh: str) -> None:
    if mesh != "card":
        raise NotImplementedError(
            f"mesh {mesh!r}: the production meshes wait for the rest of "
            f"slice G (ROADMAP item 14b: a per-rank trace of the mesh "
            f"step and its collectives); the dry run takes --mesh card")


def trace_cell(arch: str, shape_name: str, mesh: str,
               overrides: Dict[str, Any], skip_delta: bool = False
               ) -> Dict[str, Any]:
    """The record of one cell on ``mesh`` (``card``: one H100)."""
    from repro_torch import configs

    _check_mesh(mesh)
    cfg = configs.get(arch)
    ok, reason = configs.shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "skipped": True, "reason": reason}
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh,
                           "n_devices": 1, "skipped": False,
                           "overrides": overrides}
    out.update(count_cell(cfg.scaled(**overrides) if overrides else cfg,
                          shape_name, skip_delta))
    return out


def count_cell(cfg, shape_name: str, skip_delta: bool = False
               ) -> Dict[str, Any]:
    """The counts of ``cfg``'s step at ``shape_name`` on one card:
    ``production`` (the direct count), ``launches``, ``fits``, and unless
    ``skip_delta`` the unrolled 1- and 2-period counts with the
    ``delta_total`` they give over ``n_periods``."""
    def run(cfg_x):
        fn, args = _build_step(cfg_x, shape_name)
        rec = trace(fn, *args)
        rec["collectives"] = {"total_wire_bytes_per_device": 0}
        return rec

    prod = run(cfg)
    out = {"production": prod, "launches": prod["launches"],
           "fits": prod["memory"]["peak_bytes"] <= HBM_BYTES}
    if not skip_delta:
        n = _n_periods(cfg)
        u1 = run(_unroll_cfg(cfg, 1))
        u2 = run(_unroll_cfg(cfg, 2))
        out["unroll1"], out["unroll2"] = u1, u2
        delta = {k: _delta(u1[k], u2[k], n)
                 for k in ("flops", "bytes_accessed", "launches")}
        delta["collective_wire_bytes_per_device"] = 0
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
    _check_mesh(args.mesh)              # before any record is written
    overrides = _parse_set(args.set)

    from repro_torch import configs
    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_NAMES if (args.all or not args.shape) else [args.shape]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}_{args.mesh}"
            if overrides:
                tag += "_" + "_".join(f"{k}-{v}" for k, v
                                      in sorted(overrides.items()))
            path = os.path.join(args.out, tag + ".json")
            print(f"=== {tag}", flush=True)
            try:
                rec = trace_cell(arch, shape, args.mesh, overrides,
                                 skip_delta=args.skip_delta)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                       "error": str(e)[:2000]}
                failures.append(tag)
                print(f"    FAILED: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if "error" not in rec and not rec.get("skipped"):
                p = rec["production"]
                print(f"    trace {p['trace_s']}s  flops {p['flops']:.4g}  "
                      f"bytes {p['bytes_accessed']:.4g}  peak "
                      f"{p['memory']['peak_bytes'] / 2**30:.2f} GiB  fits "
                      f"{rec['fits']}  launches {rec['launches']}",
                      flush=True)
            elif rec.get("skipped"):
                print(f"    SKIP: {rec['reason']}", flush=True)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()

"""``Executor`` — the policy-driven front door for NTX programs.

Counterpart of ``repro.core.executor``. An :class:`Executor` holds an
:class:`ExecutionPolicy` (cluster count, transport, memory hierarchy,
autotune mode) and a device, and ``run``s a
:class:`~repro_torch.core.program.Program` under one of five execution
policies:

==============  =====================================================
``serial``      per-descriptor :func:`~repro_torch.core.dispatch.dispatch`
``fused``       one fused :class:`~repro_torch.core.stream.CommandStream`
``multistream`` independent sub-streams over the cluster mesh
                (:class:`~repro_torch.core.multistream.ClusterScheduler`)
``pipeline``    dependent stages with inter-cluster handoffs
                (:class:`~repro_torch.core.multistream.StageSchedule`)
``tiled``       out-of-core double-buffered tile loops through TCDM
                (:class:`~repro_torch.core.tiling.TilePlan`)
==============  =====================================================

``policy="auto"`` (the default) first consults the capacity model: a
program whose working set exceeds the cluster TCDM
(:func:`repro_torch.core.memory.fits`) is tiled. Programs that fit are
scored with the paper-derived gain ratios of
``repro_torch.perfmodel.ntx`` — ``stream_fusion_gain`` for fused vs
serial, ``multistream_gain``/``pipeline_gain`` for the mesh layers,
priced on top of fused sub-streams — and the highest score wins, the
simpler policy on ties; the same decision as the reference's on the
same program and cluster count. With
``ExecutionPolicy(autotune="measure")`` the auto decision is *measured*
instead: the candidate policies race once per program on the
executor's device, and the pick is cached. An explicit
``executor.run(program, policy="pipeline")`` overrides per call. Every
policy is bit-equal to ``serial`` on streaming and reduction programs.

The reference's ``backend`` field has no counterpart: the device of the
memory image decides between the CUDA kernels and their plain versions.

The memory image is packed on the executor's device, as a new tensor for
every run; the policies update that private image in place and unpack
it. Plans are cached on the program object keyed by its mutation
version, so a steady-state loop — a serving decode step — re-plans
nothing.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, Optional, Sequence

import torch

from .cluster import NtxClusterSpec, PAPER_CLUSTER
from .descriptor import Descriptor
from .memory import NtxMemSpec
from .program import Program, ProgramResult

POLICIES = ("auto", "serial", "fused", "multistream", "pipeline", "tiled")
TRANSPORTS = ("auto", "vmap", "shard_map", "interleave", "serial",
              "overlap")
#: auto-selection moves past a simpler policy only on a real win
_EPS = 1e-9

#: measured auto-policy picks, keyed by everything that changes which
#: candidate would win a race: the program (descriptors are hashable),
#: cluster count, transport, spec, memory hierarchy and device
_MEASURED_POLICY: Dict[tuple, Dict] = {}


def clear_measured_policy_cache() -> None:
    """Drop every measured auto-policy pick (``autotune="measure"``).

    Call after changing the execution environment in ways the memo key
    cannot see."""
    _MEASURED_POLICY.clear()


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How an :class:`Executor` runs programs.

    ``policy``      auto | serial | fused | multistream | pipeline | tiled.
    ``n_clusters``  cluster-mesh width for the graph policies; ``None``
                    means one cluster per device: the visible GPUs for a
                    CUDA executor, 1 for a CPU one.
    ``transport``   how scheduled sub-streams execute (auto | vmap |
                    shard_map | interleave | serial | overlap — the
                    scheduler modes; ``overlap`` runs the stage pipeline
                    with its window gathers on a copy stream ahead of the
                    compute).
    ``autotune``    model | measure | None (model). ``measure`` switches
                    the *auto policy* decision from the hardware model to
                    a one-off race of the candidate policies; the port's
                    GEMM plans are fixed functions of the shape, so there
                    is no block autotune for it to switch.
    ``spec``        the NTX cluster the program is written for.
    ``setup_cycles`` per-command offload setup the perf model prices.
    ``mem``         the cluster memory hierarchy the capacity model and
                    the tiled policy use; ``None`` derives it from
                    ``spec`` (:meth:`NtxMemSpec.from_cluster`).
    ``dma_overlap`` whether tiled execution issues tile i+1's DMA-in
                    ahead of tile i's compute (on a copy stream) or runs
                    phase by phase (no DMA engine).

    The reference's ``backend`` is left out: the device decides.
    """

    policy: str = "auto"
    n_clusters: Optional[int] = None
    transport: str = "auto"
    autotune: Optional[str] = None
    spec: NtxClusterSpec = PAPER_CLUSTER
    setup_cycles: int = 100
    mem: Optional[NtxMemSpec] = None
    dma_overlap: bool = True

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, "
                             f"got {self.transport!r}")
        if self.autotune not in (None, "model", "measure"):
            raise ValueError(f"autotune must be model|measure|None, "
                             f"got {self.autotune!r}")


class _TiledRunner:
    """The ``tiled`` policy's runner: a per-image-length cache of
    :class:`~repro_torch.core.tiling.TilePlan` objects (scratch-bank
    addresses are baked into the rewritten descriptors, so a plan is
    valid for one image length only)."""

    def __init__(self, descs: Sequence[Descriptor], mem_spec: NtxMemSpec,
                 overlap: bool):
        self.descs = list(descs)
        self.mem_spec = mem_spec
        self.overlap = overlap
        self._plans: Dict[int, object] = {}
        self._last = None

    def __call__(self, mem: torch.Tensor) -> torch.Tensor:
        from .tiling import TilePlan
        plan = self._plans.get(mem.shape[0])
        if plan is None:
            plan = TilePlan(self.descs, self.mem_spec,
                            image_elems=mem.shape[0])
            self._plans[mem.shape[0]] = plan
        self._last = plan
        return plan.execute(mem, overlap=self.overlap)

    @property
    def stats(self) -> Optional[Dict]:
        return self._last.stats if self._last is not None else None


def _work_done() -> int:
    """Kernel launches plus engine fallbacks so far: what a candidate of
    the measured race must not have started before it may be skipped."""
    from repro_torch.kernels import ops
    # the module: the package's ``dispatch`` is the function
    dispatch = importlib.import_module(".dispatch", __package__)
    return sum(ops.LAUNCHES.values()) + dispatch.engine_fallbacks


class Executor:
    """Policy-driven execution of NTX descriptor programs on ``device``.

    ``Executor()`` runs the auto policy on the card;
    ``Executor("pipeline", device="cpu", n_clusters=8)`` or
    ``Executor(ExecutionPolicy(...), device=...)`` pin it down. ``stats``
    after a run records the resolved policy, the gain ratios the auto
    decision consulted, and the underlying scheduler's stats.
    """

    def __init__(self, policy: "ExecutionPolicy | str | None" = None,
                 device="cuda", **overrides):
        if isinstance(policy, str):        # Executor("serial")
            overrides = {"policy": policy, **overrides}
            policy = None
        if policy is None:
            policy = ExecutionPolicy(**overrides)
        elif overrides:
            policy = dataclasses.replace(policy, **overrides)
        self.policy = policy
        self.device = torch.device(device)
        self.stats: Dict = {}

    # -- policy selection ----------------------------------------------
    def _n_clusters(self) -> int:
        from .multistream import device_count
        if self.policy.n_clusters is not None:
            return max(1, int(self.policy.n_clusters))
        return max(1, device_count(self.device))

    def _mem_spec(self) -> NtxMemSpec:
        if self.policy.mem is not None:
            return self.policy.mem
        return NtxMemSpec.from_cluster(self.policy.spec)

    def select_policy(self, descs: Sequence[Descriptor]) -> tuple:
        """(chosen policy, gain dicts) for a descriptor program.

        The capacity model rules first: a working set larger than the
        cluster TCDM tiles (``gains["tiling"]`` carries the verdict and
        the double-buffer roofline). Programs that fit are scored vs.
        one-command-at-a-time serial dispatch: ``fused`` scores the
        fusion speedup; the mesh policies price their scheduling gain on
        top of fused sub-streams, so their score is the product. The
        earliest (simplest) policy wins ties.
        """
        from repro_torch.perfmodel import ntx as perfmodel
        gains = perfmodel.policy_gains(descs, n_clusters=self._n_clusters(),
                                       spec=self.policy.spec,
                                       setup_cycles=self.policy.setup_cycles,
                                       mem=self._mem_spec())
        fusion = gains["fusion"]["speedup"]
        scores = {"serial": 1.0,
                  "fused": fusion,
                  "multistream": fusion * gains["multistream"]["speedup"],
                  "pipeline": fusion * gains["pipeline"]["speedup"]}
        if not gains["tiling"]["fits"]:
            return "tiled", {"scores": scores, **gains}
        best = "serial"
        for cand in ("fused", "multistream", "pipeline"):
            if scores[cand] > scores[best] * (1.0 + _EPS):
                best = cand
        return best, {"scores": scores, **gains}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _race_policies(self, descs: Sequence[Descriptor],
                       mem: torch.Tensor) -> tuple:
        """Measured auto policy: race the candidates once on a copy of
        the image, keep the stopwatch's pick (memoized). Each candidate
        is warmed once so planning stays out of the timed run. A
        candidate is skipped only when it raises ``ValueError`` or
        ``NotImplementedError`` before it launched anything (an illegal
        plan, e.g. ``shard_map`` on one device); any other error, or one
        raised after a launch, propagates."""
        key = (tuple(descs), self._n_clusters(), self.policy.transport,
               self.policy.spec, self.policy.setup_cycles, self._mem_spec(),
               self.policy.dma_overlap, str(self.device))
        hit = _MEASURED_POLICY.get(key)
        if hit is not None:
            return hit["policy"], {"measured": dict(hit["times_s"]),
                                   "measured_cached": True}
        times: Dict[str, float] = {}
        best, best_t = "serial", float("inf")
        for cand in ("serial", "fused", "multistream", "pipeline"):
            before = _work_done()
            try:
                runner, _ = self._build_runner(descs, cand)
                runner(mem.clone())                   # warm: plan, build
            except (ValueError, NotImplementedError):
                if _work_done() != before:
                    raise
                continue
            work = mem.clone()
            self._sync()
            t0 = time.perf_counter()
            runner(work)
            self._sync()
            dt = time.perf_counter() - t0
            times[cand] = dt
            if dt < best_t:
                best, best_t = cand, dt
        _MEASURED_POLICY[key] = {"policy": best, "times_s": times}
        return best, {"measured": times, "measured_cached": False}

    def plan(self, program_or_descs) -> Dict:
        """Resolve the policy for a program without executing it."""
        descs = (program_or_descs.descriptors
                 if isinstance(program_or_descs, Program)
                 else list(program_or_descs))
        if self.policy.policy == "auto":
            chosen, gains = self.select_policy(descs)
        else:
            chosen, gains = self.policy.policy, None
        return {"policy": chosen, "n_clusters": self._n_clusters(),
                "transport": self.policy.transport, "gains": gains}

    # -- execution -----------------------------------------------------
    def _build_runner(self, descs: Sequence[Descriptor], chosen: str):
        """The callable (mem -> mem, in place) plus its stats source."""
        from .dispatch import dispatch
        from .multistream import ClusterScheduler, StageSchedule
        from .stream import CommandStream
        if chosen == "serial":
            def run(mem):
                for d in descs:
                    mem = dispatch(d, mem)
                return mem
            return run, None
        if chosen == "fused":
            cs = CommandStream(descs)
            return cs.execute, cs
        if chosen == "tiled":
            runner = _TiledRunner(descs, self._mem_spec(),
                                  self.policy.dma_overlap)
            return runner, runner
        cls = StageSchedule if chosen == "pipeline" else ClusterScheduler
        sched = cls(descs, n_clusters=self._n_clusters(),
                    spec=self.policy.spec,
                    setup_cycles=self.policy.setup_cycles,
                    device=self.device)
        transport = self.policy.transport
        return (lambda mem: sched.execute(mem, transport)), sched

    def _resolve(self, descs: Sequence[Descriptor], policy: Optional[str],
                 mem: Optional[torch.Tensor] = None) -> tuple:
        chosen = policy or self.policy.policy
        if chosen not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {chosen!r}")
        gains = None
        if chosen == "auto":
            chosen, gains = self.select_policy(descs)
            if (chosen != "tiled" and mem is not None
                    and self.policy.autotune == "measure"):
                chosen, raced = self._race_policies(descs, mem)
                gains = {**(gains or {}), **raced}
        return chosen, gains

    def run_descriptors(self, descs: Sequence[Descriptor], mem,
                        policy: Optional[str] = None) -> torch.Tensor:
        """Execute a raw descriptor list over a flat memory image; returns
        a new image on the executor's device (``mem`` is not modified).

        The raw-descriptor layer — new code should build a
        :class:`Program` and call :meth:`run`."""
        descs = list(descs)
        mem = torch.as_tensor(mem, dtype=torch.float32,
                              device=self.device).clone()
        chosen, gains = self._resolve(descs, policy, mem)
        runner, source = self._build_runner(descs, chosen)
        out = runner(mem)
        self.stats = {"policy": chosen, "gains": gains,
                      "n_descriptors": len(descs),
                      "scheduler": getattr(source, "stats", None)}
        return out

    def run(self, program: Program, inputs=None,
            policy: Optional[str] = None) -> ProgramResult:
        """Pack, execute and unpack one program.

        ``inputs`` binds arrays or tensors to buffer handles/names (see
        :meth:`Program.pack`); ``policy`` overrides the executor's policy
        for this call (e.g. ``policy="pipeline"``). Returns a
        :class:`ProgramResult` — index it with the program's handles.
        """
        descs = program.descriptors
        cache = getattr(program, "_plan_cache", None)
        if cache is None:
            cache = {}
            program._plan_cache = cache
        # the resolved policy AND its runner per program version, so a
        # steady-state loop neither re-prices nor re-plans the program
        key = (program.version, policy or self.policy.policy,
               self._n_clusters(), self.policy.transport,
               self.policy.autotune, self.policy.spec,
               self.policy.setup_cycles, self._mem_spec(),
               self.policy.dma_overlap, str(self.device))
        mem = program.pack(inputs, self.device)
        hit = cache.get(key)
        if hit is None:
            # plans for superseded program versions can never be reused
            for stale in [k for k in cache if k[0] != program.version]:
                del cache[stale]
            chosen, gains = self._resolve(descs, policy, mem)
            hit = (chosen, gains) + self._build_runner(descs, chosen)
            cache[key] = hit
        chosen, gains, runner, source = hit
        mem = runner(mem)
        self.stats = {"policy": chosen, "gains": gains,
                      "n_descriptors": len(descs),
                      "scheduler": getattr(source, "stats", None)}
        return program.unpack(mem)

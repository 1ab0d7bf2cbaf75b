"""``Executor`` — the policy-driven front door for NTX programs.

Counterpart of ``repro.core.executor``. An :class:`Executor` holds an
:class:`ExecutionPolicy` and a device, and ``run``s a
:class:`~repro_torch.core.program.Program` under one of its execution
policies:

==============  =====================================================
``serial``      per-descriptor :func:`~repro_torch.core.dispatch.dispatch`
``fused``       one fused :class:`~repro_torch.core.stream.CommandStream`
==============  =====================================================

``fused`` is the default in the port. The reference's ``auto``,
``multistream``, ``pipeline`` and ``tiled`` policies are accepted by
:class:`ExecutionPolicy` and raise ``NotImplementedError`` when run: they
come with ROADMAP slice C. Every reference policy is bit-equal to
``serial`` on streaming programs, so a program gives the same result
under the port's ``fused`` as under any of them.

The memory image is packed on the executor's device, as a new tensor for
every run; the policies then update that private image in place and
unpack it. Plans are cached on the program object keyed by its mutation
version, so a steady-state loop — a serving decode step — re-plans
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from .cluster import NtxClusterSpec, PAPER_CLUSTER
from .descriptor import Descriptor
from .memory import NtxMemSpec
from .program import Program, ProgramResult

POLICIES = ("auto", "serial", "fused", "multistream", "pipeline", "tiled")
#: the policies this package runs; the rest come with ROADMAP slice C
PORTED_POLICIES = ("serial", "fused")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How an :class:`Executor` runs programs.

    ``policy``  auto | serial | fused | multistream | pipeline | tiled;
                only ``serial`` and ``fused`` run in this package yet.
    ``spec``    the NTX cluster the program is written for.
    ``mem``     its memory hierarchy; ``None`` derives it from ``spec``
                (:meth:`NtxMemSpec.from_cluster`).
    """

    policy: str = "fused"
    spec: NtxClusterSpec = PAPER_CLUSTER
    mem: Optional[NtxMemSpec] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")


class Executor:
    """Policy-driven execution of NTX descriptor programs on ``device``.

    ``Executor()`` runs the ``fused`` policy on the card;
    ``Executor("serial", device="cpu")`` pins both down. ``stats`` after
    a run records the policy and the command stream's stats.
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

    def _mem_spec(self) -> NtxMemSpec:
        if self.policy.mem is not None:
            return self.policy.mem
        return NtxMemSpec.from_cluster(self.policy.spec)

    def _build_runner(self, descs: Sequence[Descriptor], chosen: str):
        """The callable (mem -> mem, in place) plus its stats source."""
        from .dispatch import dispatch
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
        raise NotImplementedError(
            f"policy {chosen!r} is not ported yet (ROADMAP queue 1, slice "
            f"C); this package runs {PORTED_POLICIES}")

    def _chosen(self, policy: Optional[str]) -> str:
        chosen = policy or self.policy.policy
        if chosen not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {chosen!r}")
        return chosen

    def run_descriptors(self, descs: Sequence[Descriptor], mem,
                        policy: Optional[str] = None) -> torch.Tensor:
        """Execute a raw descriptor list over a flat memory image; returns
        a new image on the executor's device (``mem`` is not modified)."""
        descs = list(descs)
        mem = torch.as_tensor(mem, dtype=torch.float32,
                              device=self.device).clone()
        chosen = self._chosen(policy)
        runner, source = self._build_runner(descs, chosen)
        out = runner(mem)
        self.stats = {"policy": chosen, "n_descriptors": len(descs),
                      "scheduler": getattr(source, "stats", None)}
        return out

    def run(self, program: Program, inputs=None,
            policy: Optional[str] = None) -> ProgramResult:
        """Pack, execute and unpack one program.

        ``inputs`` binds arrays or tensors to buffer handles/names (see
        :meth:`Program.pack`); ``policy`` overrides the executor's policy
        for this call. Returns a :class:`ProgramResult` — index it with
        the program's handles.
        """
        descs = program.descriptors
        cache = getattr(program, "_plan_cache", None)
        if cache is None:
            cache = {}
            program._plan_cache = cache
        chosen = self._chosen(policy)
        key = (program.version, chosen, self.policy.spec, self._mem_spec())
        hit = cache.get(key)
        if hit is None:
            # plans for superseded program versions can never be reused
            for stale in [k for k in cache if k[0] != program.version]:
                del cache[stale]
            hit = self._build_runner(descs, chosen)
            cache[key] = hit
        runner, source = hit
        mem = runner(program.pack(inputs, self.device))
        self.stats = {"policy": chosen, "n_descriptors": len(descs),
                      "scheduler": getattr(source, "stats", None)}
        return program.unpack(mem)

"""Multi-cluster stream scheduling: the paper's scaled-out machine.

Counterpart of ``repro.core.multistream``, with the same analysis, costs,
assignments and ``stats``. The headline scaling claim (§III, Table II:
1 -> 8+ clusters) rests on many NTX clusters executing descriptor
streams concurrently, each hiding DMA behind compute via double-buffered
TCDM; the companion near-memory work (arXiv:1803.04783) overlaps
*dependent* stages through inter-cluster DMA.

* :class:`StreamGraph` — dependency DAG over the AGUs' affine address
  ranges: descriptor j depends on an earlier descriptor i iff their
  accesses conflict (RAW, WAR or WAW). Read-read sharing creates no edge.
* :class:`SubStream` — a group of descriptors in program order, rebased
  into a compact local memory window with its own fused
  :class:`~repro_torch.core.stream.CommandStream` and a double-buffered
  DMA/compute roofline cost.
* :class:`ClusterScheduler` — the *independent* case: the DAG's connected
  components, LPT-balanced onto the cluster mesh and executed
  concurrently.
* :class:`StageSchedule` — the *dependent* case: pipeline nodes
  level-ized into stages, each stage handoff-aware LPT-balanced and run
  concurrently; stage barriers keep every conflicting pair in program
  order, so execution stays bit-equal to the serial stream.

The transports, on the card:

* ``vmap`` — uniform lanes (one shared rebased program) run as ONE
  lane-batched execution: every group of the program is one kernel
  launch over all L lanes (:meth:`CommandStream` groups' ``run_lanes``).
  The lanes are an (L, W) stack of the memory image: where the windows
  are equally spaced and do not overlap (the serving samplers' are) the
  stack is a strided view of the image, read and written in place with
  no gather; otherwise it is gathered once and its write columns are
  scattered back once, as indexed copies. The same code runs on a CPU
  image through the kernels' plain versions.
* ``shard_map`` — the lanes split over the GPUs, one block of lanes per
  card; on one device it raises ``ValueError`` (``auto`` never picks it
  below two devices).
* ``interleave`` — a host loop over the sub-streams at fused-group
  granularity, on views of the image.
* ``overlap`` (stages) — every stage's window gathers are issued on a
  copy stream before the previous stage computes on the compute stream,
  ordered by CUDA events; on a CPU image in program order.

Unlike the reference's functional transports, ``execute`` updates the
image it is given in place and returns it (as ``CommandStream.execute``
does); the Executor hands it a private copy.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cluster import NtxClusterSpec, PAPER_CLUSTER
from .descriptor import Descriptor
from .stream import (CommandStream, desc_spans, merge_spans, span_empty,
                     spans_overlap)

Span = Tuple[int, int]

_ELEM_BYTES = 4


def device_count(device=None) -> int:
    """Devices a lane may run on: the visible GPUs for a CUDA device,
    1 for the CPU (the reference's ``len(jax.devices())``)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def lane_devices(mem: torch.Tensor) -> List[torch.device]:
    """The devices ``shard_map`` spreads lanes over for an image on
    ``mem.device``: every visible GPU, or the CPU alone."""
    if mem.is_cuda:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [mem.device]


def _conflict(a_reads, a_write, b_reads, b_write) -> bool:
    """True iff the two descriptors must stay ordered (RAW/WAR/WAW)."""
    if spans_overlap(a_write, b_write):
        return True
    if any(spans_overlap(a_write, r) for r in b_reads):
        return True
    return any(spans_overlap(b_write, r) for r in a_reads)


def _intersect_bytes(a_spans: Sequence[Span], b_spans: Sequence[Span],
                     elem_bytes: int = _ELEM_BYTES) -> int:
    """Bytes in the intersection of two merged span lists."""
    return elem_bytes * sum(
        max(0, min(a_hi, b_hi) - max(a_lo, b_lo))
        for a_lo, a_hi in a_spans for b_lo, b_hi in b_spans)


# ----------------------------------------------------------------------
# Sub-streams
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SubStream:
    """One node of the schedule (component or pipeline stage node), in
    program order.

    ``descs`` are the original descriptors; ``local`` the same descriptors
    rebased so the window [lo, hi) maps to local addresses [0, size).
    ``read_ranges``/``write_ranges`` are the merged global footprints the
    handoff planner sizes inter-cluster DMAs with.
    """

    indices: Tuple[int, ...]
    descs: List[Descriptor]
    lo: int
    hi: int
    write_ranges: List[Span]            # global, merged
    read_ranges: List[Span] = dataclasses.field(default_factory=list)
    local: List[Descriptor] = dataclasses.field(default_factory=list)
    stream: CommandStream = None

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def roofline_time(self, spec: NtxClusterSpec = PAPER_CLUSTER,
                      setup_cycles: int = 100, overlap: bool = True) -> float:
        """Time on ONE cluster: double-buffered max(compute, dma) per fused
        group (overlap=False: the costs add — no DMA engine), plus the
        per-group offload setup the RISC-V pays."""
        flops = self.stream.flops()
        byts = self.stream.bytes_moved()
        tc = flops / spec.practical_flops
        td = byts / spec.practical_bw
        t = max(tc, td) if overlap else (tc + td)
        return t + setup_cycles / spec.ntx_freq_hz * len(self.stream.groups)

    def run(self, window: torch.Tensor) -> torch.Tensor:
        """The sub-stream's groups over its window, in place."""
        st = self.stream._fresh_stats()
        for g in self.stream.groups:
            g.run(window, st)
        return window


def _rebase(desc: Descriptor, lo: int) -> Descriptor:
    shift = lambda agu: dataclasses.replace(agu, base=agu.base - lo)
    kw = {"agu2": shift(desc.agu2)}
    if desc.reads_per_iter >= 1:
        kw["agu0"] = shift(desc.agu0)
    if desc.reads_per_iter >= 2:
        kw["agu1"] = shift(desc.agu1)
    return dataclasses.replace(desc, **kw)


# ----------------------------------------------------------------------
# Strongly-connected components (iterative Tarjan)
# ----------------------------------------------------------------------
def _tarjan_scc(n: int, succ: List[List[int]]) -> Tuple[List[int], int]:
    """Component id per node. Cycles in the preliminary node graph (write
    ping-pong across regions) must merge into one pipeline node."""
    index: List[Optional[int]] = [None] * n
    low = [0] * n
    onstk = [False] * n
    stk: List[int] = []
    comp = [0] * n
    counter = 0
    ncomp = 0
    for root in range(n):
        if index[root] is not None:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stk.append(v)
                onstk[v] = True
            advanced = False
            for i in range(pi, len(succ[v])):
                w = succ[v][i]
                if index[w] is None:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if onstk[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                while True:
                    w = stk.pop()
                    onstk[w] = False
                    comp[w] = ncomp
                    if w == v:
                        break
                ncomp += 1
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
    return comp, ncomp


# ----------------------------------------------------------------------
# The DAG
# ----------------------------------------------------------------------
class StreamGraph:
    """Dependency DAG over a descriptor program's AGU address ranges."""

    def __init__(self, descs: Sequence[Descriptor]):
        self.descs = list(descs)
        spans = [desc_spans(d) for d in self.descs]
        n = len(self.descs)
        self.edges: List[Tuple[int, int]] = []
        parent = list(range(n))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for j in range(n):
            rj, wj = spans[j]
            for i in range(j):
                ri, wi = spans[i]
                if _conflict(ri, wi, rj, wj):
                    self.edges.append((i, j))
                    parent[find(i)] = find(j)
        self._roots = [find(i) for i in range(n)]
        self._spans = spans

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def _make_substream(self, idxs: Sequence[int]) -> SubStream:
        descs = [self.descs[i] for i in idxs]
        touched: List[Span] = []
        writes: List[Span] = []
        reads: List[Span] = []
        for i in idxs:
            r, w = self._spans[i]
            reads.extend(r)
            writes.append(w)
            touched.extend(r)
            touched.append(w)
        touched = [s for s in touched if not span_empty(s)]
        lo = min((s[0] for s in touched), default=0)
        hi = max((s[1] for s in touched), default=0)
        sub = SubStream(indices=tuple(idxs), descs=descs, lo=lo, hi=hi,
                        write_ranges=merge_spans(writes),
                        read_ranges=merge_spans(reads))
        sub.local = [_rebase(d, lo) for d in descs]
        sub.stream = CommandStream(sub.local)
        return sub

    def partition(self) -> List[SubStream]:
        """Fully independent sub-streams (connected components),
        deterministically ordered by the index of their first descriptor;
        each keeps program order internally."""
        comps: dict = {}
        for i, r in enumerate(self._roots):
            comps.setdefault(r, []).append(i)
        return [self._make_substream(idxs)
                for idxs in sorted(comps.values(), key=lambda ix: ix[0])]

    def pipeline_partition(self) -> Tuple[List[SubStream],
                                          List[Tuple[int, int]]]:
        """Pipeline nodes + node-level dependency edges.

        Descriptors whose *write* footprints overlap form one node (an
        in-place chain, an accumulator region); descriptor conflicts lift
        to node edges; cyclic node groups (region ping-pong) SCC-condense
        into a single node so the result is a DAG. Nodes are ordered by
        first descriptor index and keep program order internally."""
        n = len(self.descs)
        parent = list(range(n))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        # every write-write overlap is already a WAW conflict edge
        for i, j in self.edges:
            if spans_overlap(self._spans[i][1], self._spans[j][1]):
                parent[find(i)] = find(j)
        groups: dict = {}
        for i in range(n):
            groups.setdefault(find(i), []).append(i)
        prelim = sorted(groups.values(), key=lambda ix: ix[0])
        node_of = {}
        for gi, idxs in enumerate(prelim):
            for i in idxs:
                node_of[i] = gi
        succ: List[List[int]] = [[] for _ in prelim]
        seen = set()
        for i, j in self.edges:
            u, v = node_of[i], node_of[j]
            if u != v and (u, v) not in seen:
                seen.add((u, v))
                succ[u].append(v)
        comp, _ = _tarjan_scc(len(prelim), succ)
        merged: dict = {}
        for gi, idxs in enumerate(prelim):
            merged.setdefault(comp[gi], []).extend(idxs)
        final = sorted((sorted(ix) for ix in merged.values()),
                       key=lambda ix: ix[0])
        node_id = {}
        for fi, idxs in enumerate(final):
            for i in idxs:
                node_id[i] = fi
        nodes = [self._make_substream(idxs) for idxs in final]
        nedges = sorted({(node_id[i], node_id[j]) for i, j in self.edges
                         if node_id[i] != node_id[j]})
        return nodes, nedges


# ----------------------------------------------------------------------
# Load balancing
# ----------------------------------------------------------------------
def _lpt_assign(costs: Sequence[float], n_clusters: int) -> List[int]:
    """Longest-processing-time-first onto the least-loaded cluster.

    Deterministic: ties broken by sub-stream index, then cluster index.
    Always a valid partition, also when ``n_clusters`` exceeds the number
    of sub-streams or costs are 0 (extra clusters stay empty)."""
    n_clusters = max(1, int(n_clusters))
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    load = [0.0] * n_clusters
    assign = [0] * len(costs)
    for i in order:
        c = min(range(n_clusters), key=lambda k: (load[k], k))
        assign[i] = c
        load[c] += costs[i]
    return assign


# ----------------------------------------------------------------------
# Shared sub-stream executors
# ----------------------------------------------------------------------
def _substreams_uniform(subs: Sequence[SubStream]) -> bool:
    """All sub-streams share one rebased program (and window size) — the
    data-parallel-clusters case the paper scales: one kernel, per-cluster
    data tiles. Only then can the lanes stack for vmap/shard_map."""
    if not subs:
        return False
    first = subs[0]
    return all(s.size == first.size and s.local == first.local
               for s in subs[1:])


def _substreams_traceable(subs: Sequence[SubStream]) -> bool:
    from .dispatch import traceable_descriptor
    return all(traceable_descriptor(d) for s in subs for d in s.local)


def _run_interleaved(mem: torch.Tensor,
                     subs: Sequence[SubStream]) -> Tuple[torch.Tensor, int]:
    """Round-robin over sub-streams at fused-group granularity — the host
    stands in for the per-cluster DMA engines, issuing one group per
    cluster per turn. The sub-streams are mutually independent, so each
    runs on a view of its window of ``mem``, in place, and any
    interleaving is bit-identical to serial execution. Returns the
    updated memory and the number of turns."""
    windows = [mem[s.lo:s.hi] for s in subs]
    stats = [s.stream._fresh_stats() for s in subs]
    cursors = [0] * len(subs)
    done = 0
    while done < len(subs):
        done = 0
        for i, sub in enumerate(subs):
            groups = sub.stream.groups
            if cursors[i] >= len(groups):
                done += 1
                continue
            groups[cursors[i]].run(windows[i], stats[i])
            cursors[i] += 1
    return mem, max((len(s.stream.groups) for s in subs), default=0)


class LaneStack:
    """Uniform sub-streams run as lanes: every group of their shared
    rebased program once over an (L, W) stack of their windows.

    Where the windows are equally spaced (spacing >= W) the stack is a
    strided view of the image, so the kernels read and write the image
    in place; otherwise the windows are gathered with one indexed copy
    and the program's write columns scattered back with another."""

    def __init__(self, subs: Sequence[SubStream]):
        self.subs = list(subs)
        self.groups = self.subs[0].stream.groups
        self.size = self.subs[0].size
        los = np.asarray([s.lo for s in self.subs], np.int64)
        steps = np.diff(los)
        self.spacing = None
        if len(los) == 1:
            self.spacing = max(1, self.size)
        elif (steps == steps[0]).all() and steps[0] >= self.size:
            self.spacing = int(steps[0])
        self.los = los
        first = self.subs[0]
        cols = [np.arange(lo - first.lo, hi - first.lo)
                for lo, hi in first.write_ranges]
        self.write_cols = (np.concatenate(cols) if cols
                           else np.zeros(0, np.int64))
        self._index: Dict[tuple, tuple] = {}

    @property
    def strided(self) -> bool:
        return self.spacing is not None

    def _indices(self, device: torch.device, lanes=slice(None)) -> tuple:
        """(window index (L, W), write index (L, |write cols|)) on
        ``device``, made once per device and lane block."""
        key = (str(device), lanes.start, lanes.stop)
        hit = self._index.get(key)
        if hit is None:
            los = torch.as_tensor(self.los[lanes], device=device)
            win = los[:, None] + torch.arange(self.size, device=device)
            cols = torch.as_tensor(self.write_cols, device=device)
            hit = (win, win[:, cols], cols)
            self._index[key] = hit
        return hit

    def _run(self, stack: torch.Tensor) -> torch.Tensor:
        st = self.subs[0].stream._fresh_stats()
        for g in self.groups:
            g.run_lanes(stack, st)
        return stack

    def run(self, mem: torch.Tensor) -> torch.Tensor:
        """The lanes over the 1-D image ``mem``, in place."""
        if self.strided and mem.is_contiguous():
            stack = mem.as_strided((len(self.subs), self.size),
                                   (self.spacing, 1),
                                   mem.storage_offset() + int(self.los[0]))
            self._run(stack)
            return mem
        win, wr, cols = self._indices(mem.device)
        stack = self._run(mem[win])
        mem[wr] = stack[:, cols]
        return mem

    def run_sharded(self, mem: torch.Tensor, devices: Sequence,
                    stats: Optional[dict] = None) -> torch.Tensor:
        """The lanes split into contiguous blocks, one block per device:
        each block's windows gathered onto its device, run there, and the
        write columns scattered back into ``mem``."""
        n_lanes = len(self.subs)
        n_dev = min(len(devices), n_lanes)
        if stats is not None:
            stats["n_devices_used"] = n_dev
        per = -(-n_lanes // n_dev)
        outs = []
        for d in range(n_dev):
            block = slice(d * per, min(n_lanes, (d + 1) * per))
            if block.start >= block.stop:
                continue
            win, _, _ = self._indices(mem.device, block)
            stack = mem[win].to(devices[d], non_blocking=True)
            outs.append((block, self._run(stack)))
        for block, stack in outs:
            _, wr, cols = self._indices(mem.device, block)
            mem[wr] = stack[:, cols.to(stack.device)].to(mem.device)
        return mem


def _stacked(subs: Sequence[SubStream], mode: str, mem: torch.Tensor,
             cache: dict, key, stats: dict) -> torch.Tensor:
    """Run uniform, traceable sub-streams as lanes: ``vmap`` on the
    image's device, ``shard_map`` over the GPUs (two or more)."""
    lanes = cache.get(key)
    if lanes is None:
        lanes = cache[key] = LaneStack(subs)
    if mode == "vmap":
        stats["lane_view"] = lanes.strided
        return lanes.run(mem)
    devices = lane_devices(mem)
    if len(devices) < 2:
        raise ValueError(
            f"mode 'shard_map' runs one block of lanes per GPU and needs "
            f"two or more devices; this image is on {mem.device} with "
            f"{len(devices)} (use mode='vmap', 'interleave' or 'auto')")
    return lanes.run_sharded(mem, devices, stats)


# ----------------------------------------------------------------------
# The scheduler: independent components
# ----------------------------------------------------------------------
class ClusterScheduler:
    """Maps a program's independent sub-streams onto a cluster mesh.

    Execution modes (``execute(mem, mode=...)``):

    * ``"shard_map"`` — the lanes in blocks over the GPUs, one block per
      card. Requires uniform + traceable sub-streams and >= 2 devices
      (``ValueError`` on one).
    * ``"vmap"``      — the lanes batched on the image's device: each
      group of the shared program is ONE kernel launch over all lanes.
      Requires uniform + traceable.
    * ``"interleave"``— host loop, always legal: sub-streams run on views
      of their windows round-robin at fused-group granularity.
    * ``"serial"``    — one CommandStream over the whole program (oracle).
    * ``"auto"``      — shard_map if legal and >= 2 devices, else vmap
      if legal, else interleave.

    Every mode is bit-equal to serial execution for streaming and
    reduction programs, and equal within the kernels' tolerance for GEMM
    programs (the same kernel, batched). ``n_clusters=None`` means one
    cluster per device of ``device`` (the GPUs for CUDA, 1 for the CPU).
    """

    def __init__(self, descs_or_graph, n_clusters: Optional[int] = None,
                 spec: NtxClusterSpec = PAPER_CLUSTER,
                 setup_cycles: int = 100, device=None):
        self.graph = (descs_or_graph if isinstance(descs_or_graph, StreamGraph)
                      else StreamGraph(descs_or_graph))
        self.spec = spec
        self.substreams = self.graph.partition()
        if n_clusters is None:
            n_clusters = max(1, device_count(device))
        self.n_clusters = max(1, int(n_clusters))
        self.costs = [s.roofline_time(spec, setup_cycles)
                      for s in self.substreams]
        self.assignment = _lpt_assign(self.costs, self.n_clusters)
        self._lanes: dict = {}
        self._serial: Optional[CommandStream] = None
        self.stats = {
            "n_descriptors": len(self.graph.descs),
            "n_substreams": len(self.substreams),
            "n_edges": self.graph.n_edges,
            "n_clusters": self.n_clusters,
            "assignment": list(self.assignment),
            "uniform": self.uniform(),
            "traceable": self.traceable(),
            "cluster_times_s": self.cluster_times(),
            "critical_path_s": max(self.cluster_times(), default=0.0),
            "serial_time_s": sum(self.costs),
            "mode_used": None,
        }

    # -- analysis ------------------------------------------------------
    def cluster_times(self) -> List[float]:
        t = [0.0] * self.n_clusters
        for cost, c in zip(self.costs, self.assignment):
            t[c] += cost
        return t

    def model_speedup(self) -> float:
        crit = max(self.cluster_times(), default=0.0) if self.costs else 0.0
        return sum(self.costs) / crit if crit > 0 else 1.0

    def uniform(self) -> bool:
        return _substreams_uniform(self.substreams)

    def traceable(self) -> bool:
        return _substreams_traceable(self.substreams)

    def plan_mode(self, mode: str = "auto", device=None) -> str:
        """The mode ``execute`` runs for ``mode`` on an image on
        ``device`` (``None``: the CPU)."""
        if mode == "overlap":
            # stage overlap is a pipeline concept; independent sub-streams
            # have no stage boundaries, so fall back to the best transport
            mode = "auto"
        if mode != "auto":
            return mode
        if self.uniform() and self.traceable():
            if device_count(device) >= 2 and len(self.substreams) >= 2:
                return "shard_map"
            return "vmap"
        return "interleave"

    # -- execution -----------------------------------------------------
    def execute(self, mem: torch.Tensor, mode: str = "auto") -> torch.Tensor:
        """Run the program over the fp32 image ``mem``, in place."""
        mode = self.plan_mode(mode, mem.device)
        self.stats["mode_used"] = mode
        if mode == "serial":
            if self._serial is None:
                self._serial = CommandStream(self.graph.descs)
            return self._serial.execute(mem)
        if mode == "interleave":
            mem, turns = _run_interleaved(mem, self.substreams)
            self.stats["interleave_turns"] = turns
            return mem
        if mode in ("vmap", "shard_map"):
            if not (self.uniform() and self.traceable()):
                raise ValueError(
                    f"mode {mode!r} needs uniform, traceable sub-streams "
                    "(use mode='interleave' or 'auto')")
            return _stacked(self.substreams, mode, mem, self._lanes, mode,
                            self.stats)
        raise ValueError(f"unknown mode {mode!r}")


# ----------------------------------------------------------------------
# The pipeline: dependent stages with inter-cluster handoffs
# ----------------------------------------------------------------------
#: (device index) -> the side stream ``overlap`` issues window gathers on
_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _copy_stream(device: torch.device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    s = _COPY_STREAMS.get(idx)
    if s is None:
        s = _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


class StageSchedule:
    """Stage-level pipeline schedule for DEPENDENT descriptor programs.

    ``pipeline_partition`` keeps the dependency edges instead of
    collapsing connected components to one queue: nodes level-ize
    topologically into stages; nodes inside one stage are mutually
    conflict-free and execute concurrently with the same transports as
    :class:`ClusterScheduler`; stage barriers (in place on the image)
    realise every cross-stage handoff, so every execution mode stays
    bit-equal to the serial stream.

    ``execute(mem, mode=...)`` takes a per-stage transport *preference*:
    ``"vmap"``/``"shard_map"`` stack a stage's lanes when that stage is
    uniform + traceable (``shard_map`` raises on one device) and fall
    back to interleaved host execution otherwise; ``"interleave"`` always
    interleaves; ``"serial"`` is the one-queue oracle; ``"overlap"`` the
    §IV schedule without hard barriers; ``"auto"`` picks shard_map on >=
    2 devices, else vmap.
    """

    def __init__(self, descs_or_graph, n_clusters: Optional[int] = None,
                 spec: NtxClusterSpec = PAPER_CLUSTER,
                 setup_cycles: int = 100, device=None):
        self.graph = (descs_or_graph if isinstance(descs_or_graph, StreamGraph)
                      else StreamGraph(descs_or_graph))
        self.spec = spec
        self.setup_cycles = setup_cycles
        self.nodes, self.node_edges = self.graph.pipeline_partition()
        if n_clusters is None:
            n_clusters = max(1, device_count(device))
        self.n_clusters = max(1, int(n_clusters))

        n = len(self.nodes)
        succs: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for u, v in self.node_edges:
            succs[u].append(v)
            indeg[v] += 1
        self.level = [0] * n
        q = deque(i for i in range(n) if indeg[i] == 0)
        seen = 0
        while q:
            u = q.popleft()
            seen += 1
            for v in succs[u]:
                self.level[v] = max(self.level[v], self.level[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    q.append(v)
        assert seen == n, "pipeline_partition must produce a DAG"
        n_stages = (max(self.level) + 1) if n else 0
        self.stages: List[List[int]] = [[] for _ in range(n_stages)]
        for i in range(n):
            self.stages[self.level[i]].append(i)

        self.costs = [nd.roofline_time(spec, setup_cycles)
                      for nd in self.nodes]
        # per-edge handoff sizing: the producer's write spans restricted
        # to the consumer's read footprint
        self._edge_bytes = {
            (u, v): _intersect_bytes(self.nodes[u].write_ranges,
                                     self.nodes[v].read_ranges)
            for u, v in self.node_edges}
        in_edges: Dict[int, List[Tuple[int, int]]] = {}
        for (u, v), nbytes in self._edge_bytes.items():
            in_edges.setdefault(v, []).append((u, nbytes))
        self._in_edges = in_edges

        # handoff-aware stage LPT: longest node first onto the cluster
        # minimising (stage load + the DMA a non-co-located placement
        # would pay); producers sit in earlier stages, already placed
        bw = spec.practical_bw
        self.assignment = [0] * n
        for stage in self.stages:
            load = [0.0] * self.n_clusters
            for i in sorted(stage, key=lambda j: (-self.costs[j], j)):
                def placed_cost(k: int) -> float:
                    dma = sum(nb / bw for u, nb in in_edges.get(i, ())
                              if self.assignment[u] != k)
                    return load[k] + dma
                c = min(range(self.n_clusters),
                        key=lambda k: (placed_cost(k), load[k], k))
                self.assignment[i] = c
                load[c] += self.costs[i]

        self.handoffs: List[Dict] = []
        for u, v in self.node_edges:
            self.handoffs.append({
                "src": u, "dst": v, "bytes": self._edge_bytes[(u, v)],
                "cross_cluster": self.assignment[u] != self.assignment[v],
                "stage": self.level[v]})

        self._lanes: dict = {}
        self._serial: Optional[CommandStream] = None
        self.stats = {
            "n_descriptors": len(self.graph.descs),
            "n_nodes": n,
            "n_edges": len(self.node_edges),
            "n_stages": n_stages,
            "n_clusters": self.n_clusters,
            "levels": list(self.level),
            "assignment": list(self.assignment),
            "stage_sizes": [len(s) for s in self.stages],
            "handoff_bytes": sum(h["bytes"] for h in self.handoffs),
            "handoff_bytes_cross": sum(h["bytes"] for h in self.handoffs
                                       if h["cross_cluster"]),
            "serial_time_s": sum(self.costs),
            "pipeline_time_s": self.model_time(),
            "pipeline_overlap_time_s": self.model_time(overlap=True),
            "stage_times_s": self.stage_times(),
            "mode_used": None,
        }

    # -- analysis ------------------------------------------------------
    def stage_times(self) -> List[float]:
        """Per-stage critical path: the most-loaded cluster of each stage."""
        out = []
        for stage in self.stages:
            load = [0.0] * self.n_clusters
            for i in stage:
                load[self.assignment[i]] += self.costs[i]
            out.append(max(load))
        return out

    def handoff_time(self) -> float:
        """DMA time of the cross-cluster handoffs at the practical rate."""
        nbytes = sum(h["bytes"] for h in self.handoffs if h["cross_cluster"])
        return nbytes / self.spec.practical_bw

    def overlap_handoff_time(self) -> float:
        """Cross-cluster handoff DMA *not* hidden by the overlapped
        schedule: per edge, the excess over the producer stage's slack
        after its producer, ``stage_t[level(u)] - cost(u)``."""
        bw = self.spec.practical_bw
        stage_t = self.stage_times()
        exposed = 0.0
        for h in self.handoffs:
            if not h["cross_cluster"]:
                continue
            u = h["src"]
            slack = max(0.0, stage_t[self.level[u]] - self.costs[u])
            exposed += max(0.0, h["bytes"] / bw - slack)
        return exposed

    def model_time(self, overlap: bool = False) -> float:
        """Pipelined time: sum of stage critical paths + handoff DMA
        (all of it under the barrier schedule, only the un-hidden excess
        under the overlapped one)."""
        handoff = (self.overlap_handoff_time() if overlap
                   else self.handoff_time())
        return sum(self.stage_times()) + handoff

    def model_speedup(self, overlap: bool = False) -> float:
        t = self.model_time(overlap)
        return sum(self.costs) / t if t > 0 else 1.0

    def plan_stage_mode(self, stage: Sequence[int], mode: str = "auto",
                        device=None) -> str:
        if mode == "interleave":
            return "interleave"
        subs = [self.nodes[i] for i in stage]
        if (len(subs) >= 2 and _substreams_uniform(subs)
                and _substreams_traceable(subs)):
            if mode in ("vmap", "shard_map"):
                return mode
            return "shard_map" if device_count(device) >= 2 else "vmap"
        return "interleave"

    # -- execution -----------------------------------------------------
    def _execute_overlap(self, mem: torch.Tensor) -> torch.Tensor:
        """The §IV overlapped schedule (no hard stage barriers).

        Every node's window gathers from the PRE-program image, and stage
        s+1's gathers are issued before stage s computes: on a CUDA image
        on a copy stream, each node's compute waiting on its gather's
        event (its window is recorded on the compute stream, so the
        allocator keeps it); on a CPU image in that order. Dependent data
        moves producer-window -> consumer-window, and all write-backs
        defer to the end (distinct pipeline nodes have disjoint write
        hulls, so they commute). Bit-equal to the barrier schedule."""
        cuda = mem.is_cuda
        if cuda:
            compute = torch.cuda.current_stream(mem.device)
            copy = _copy_stream(mem.device)
            copy.wait_stream(compute)          # the image is packed
        windows: Dict[int, torch.Tensor] = {}
        ready: Dict[int, object] = {}

        def gather(stage):
            for i in stage:
                nd = self.nodes[i]
                if not cuda:
                    windows[i] = mem[nd.lo:nd.hi].clone()
                    continue
                with torch.cuda.stream(copy):
                    w = mem[nd.lo:nd.hi].clone()
                    ev = torch.cuda.Event()
                    ev.record(copy)
                w.record_stream(compute)
                windows[i], ready[i] = w, ev

        if self.stages:
            gather(self.stages[0])
        for si, stage in enumerate(self.stages):
            if si + 1 < len(self.stages):
                gather(self.stages[si + 1])    # DMA-in of stage s+1 first
            for i in stage:
                nd = self.nodes[i]
                if cuda:
                    compute.wait_event(ready[i])
                w = windows[i]
                for u, _ in self._in_edges.get(i, ()):
                    und = self.nodes[u]
                    for lo, hi in und.write_ranges:
                        plo, phi = max(lo, nd.lo), min(hi, nd.hi)
                        if plo < phi:
                            w[plo - nd.lo:phi - nd.lo] = \
                                windows[u][plo - und.lo:phi - und.lo]
                nd.run(w)
        for i, nd in enumerate(self.nodes):
            for lo, hi in nd.write_ranges:
                mem[lo:hi] = windows[i][lo - nd.lo:hi - nd.lo]
        return mem

    def execute(self, mem: torch.Tensor, mode: str = "auto") -> torch.Tensor:
        """Run the program over the fp32 image ``mem``, in place."""
        if mode == "serial":
            self.stats["mode_used"] = "serial"
            if self._serial is None:
                self._serial = CommandStream(self.graph.descs)
            return self._serial.execute(mem)
        if mode == "overlap":
            self.stats["mode_used"] = "overlap"
            self.stats["stage_modes"] = ["overlap"] * len(self.stages)
            return self._execute_overlap(mem)
        if mode not in ("auto", "vmap", "shard_map", "interleave"):
            raise ValueError(f"unknown mode {mode!r}")
        stage_modes = []
        for si, stage in enumerate(self.stages):
            m = self.plan_stage_mode(stage, mode, mem.device)
            stage_modes.append(m)
            subs = [self.nodes[i] for i in stage]
            if m == "interleave":
                mem, _ = _run_interleaved(mem, subs)
            else:
                mem = _stacked(subs, m, mem, self._lanes, (si, m),
                               self.stats)
        self.stats["mode_used"] = mode
        self.stats["stage_modes"] = stage_modes
        return mem

"""The paper's analytical performance model (§III-B/C of the paper, and
the execution-time model of [12] it references).

Kernel time on one cluster = pipelined max(compute, dma) per double-buffered
tile (core/scheduler.py), with the practically-achievable rates derated by
the measured 13% TCDM banking-conflict probability:

    compute rate = 20 Gflop/s * (1 - 0.13) = 17.4 Gflop/s
    memory rate  =  5 GB/s    * (1 - 0.13) = 4.35 GB/s

This module evaluates the paper's §III-B kernel suite and reproduces the
Figure-5 roofline points, Table-I figures of merit, and the NTX 16x..512x
cluster-scaling efficiencies of Table II / Figures 6-7. Counterpart of
``repro.perfmodel.ntx``: pure arithmetic over the port's descriptors and
schedulers, giving the reference's numbers on the same program. The
Executor's ``auto`` policy chooses with :func:`policy_gains`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.cluster import (NtxClusterSpec, PAPER_CLUSTER,
                                      ntx_multi_cluster)
from repro_torch.core.memory import NtxMemSpec
from repro_torch.core import scheduler as sched


@dataclasses.dataclass(frozen=True)
class KernelPoint:
    name: str
    flops: int
    bytes_dram: int
    time_s: float

    @property
    def intensity(self) -> float:
        return self.flops / max(1, self.bytes_dram)

    @property
    def gflops(self) -> float:
        return self.flops / self.time_s / 1e9

    @property
    def bw_gbs(self) -> float:
        return self.bytes_dram / self.time_s / 1e9


def _run(name: str, schedule: sched.TileSchedule,
         spec: NtxClusterSpec = PAPER_CLUSTER,
         setup_cycles: int = 100) -> KernelPoint:
    t = schedule.time_s(spec.practical_flops, spec.practical_bw,
                        overlap=True, setup_cycles=setup_cycles,
                        freq_hz=spec.ntx_freq_hz)
    return KernelPoint(name, schedule.total_flops, schedule.total_bytes, t)


# ----------------------------------------------------------------------
# Paper §III-B kernel suite
# ----------------------------------------------------------------------
def axpy(n: int, spec=PAPER_CLUSTER) -> KernelPoint:
    return _run(f"AXPY {n}", sched.schedule_axpy(n, spec.tcdm_bytes), spec)


def gemv(m: int, n: int, spec=PAPER_CLUSTER) -> KernelPoint:
    return _run(f"GEMV {m}", sched.schedule_gemv(m, n, spec.tcdm_bytes), spec)


def gemm(m: int, n: int, k: int, spec=PAPER_CLUSTER) -> KernelPoint:
    return _run(f"GEMM {m}", sched.schedule_gemm(m, n, k, spec.tcdm_bytes),
                spec)


def conv2d(h: int, w: int, ksize: int, spec=PAPER_CLUSTER,
           c_in: int = 16, c_out: int = 16) -> KernelPoint:
    """DNN-style multi-channel convolution (the paper's conv workload)."""
    return _run(f"CONV {ksize}x{ksize}",
                sched.schedule_conv2d(h, w, ksize, ksize, spec.tcdm_bytes,
                                      c_in=c_in, c_out=c_out), spec)


def laplace(dim: int, n: int, spec=PAPER_CLUSTER) -> KernelPoint:
    points = 2 * dim + 1
    shape = tuple([n] * dim)
    return _run(f"LAP{dim}D", sched.schedule_stencil(shape, points,
                                                     spec.tcdm_bytes), spec)


def diffusion(n: int, spec=PAPER_CLUSTER) -> KernelPoint:
    # 13-coefficient stencil, decomposed 9+2+2 (paper §III-B3)
    return _run("DIFF", sched.schedule_stencil((n, n), 13, spec.tcdm_bytes),
                spec)


def figure5_suite(spec=PAPER_CLUSTER) -> Dict[str, KernelPoint]:
    """The kernel/size grid of the paper's Figure 5."""
    out: Dict[str, KernelPoint] = {}
    for n in (1 << 10, 1 << 14, 1 << 18, 1 << 22):
        p = axpy(n, spec)
        out[f"AXPY {n}"] = p
    for m in (16, 128, 1024, 16384):
        out[f"GEMV {m}"] = gemv(m, m, spec)
    for m in (16, 64, 256, 1024):
        out[f"GEMM {m}"] = gemm(m, m, m, spec)
    for ks in (3, 5, 7):
        out[f"CONV {ks}x{ks}"] = conv2d(256, 256, ks, spec)
    for d in (1, 2, 3):
        n = {1: 1 << 22, 2: 2048, 3: 160}[d]
        out[f"LAP{d}D"] = laplace(d, n, spec)
    out["DIFF"] = diffusion(2048, spec)
    return out


def _ratio(num: float, den: float) -> float:
    """Guarded gain ratio: an empty program or a zero-cost denominator
    (e.g. a single zero-trip descriptor) is neither a speedup nor a
    slowdown — the ratio is defined as 1.0, never inf/nan."""
    return num / den if den > 0 else 1.0


# ----------------------------------------------------------------------
# Command-stream fusion pricing (§II-E offload model)
# ----------------------------------------------------------------------
def stream_fusion_gain(descs, spec: NtxClusterSpec = PAPER_CLUSTER,
                       setup_cycles: int = 100) -> Dict[str, float]:
    """Price a descriptor stream executed fused vs. one-command-at-a-time.

    Sequential execution pays the full DMA traffic of every command plus a
    per-command offload setup; the fused stream (``core.stream``) keeps
    chain intermediates scratchpad-resident, so it moves only each fused
    group's external bytes and amortises setup once per group. Time is the
    paper's roofline max(compute, dma) at the derated practical rates.
    """
    from repro_torch.core.stream import CommandStream
    cs = CommandStream(descs)
    flops = cs.flops()
    setup = setup_cycles / spec.ntx_freq_hz
    bytes_seq = cs.bytes_sequential()
    bytes_fused = cs.bytes_moved()
    t_seq = max(flops / spec.practical_flops,
                bytes_seq / spec.practical_bw) + setup * len(cs.descs)
    t_fused = max(flops / spec.practical_flops,
                  bytes_fused / spec.practical_bw) + setup * len(cs.groups)
    return {"flops": float(flops),
            "bytes_sequential": float(bytes_seq),
            "bytes_fused": float(bytes_fused),
            "time_sequential_s": t_seq,
            "time_fused_s": t_fused,
            "speedup": _ratio(t_seq, t_fused),
            "n_groups": float(len(cs.groups)),
            "n_fused_groups": float(sum(1 for g in cs.groups if g.fused))}


# ----------------------------------------------------------------------
# Multi-cluster stream scheduling (§III scaling, Table II)
# ----------------------------------------------------------------------
def multistream_gain(descs, n_clusters: int = 4,
                     spec: NtxClusterSpec = PAPER_CLUSTER,
                     setup_cycles: int = 100) -> Dict[str, float]:
    """Price a descriptor program scheduled across ``n_clusters`` clusters
    vs. one serial stream.

    Each independent sub-stream (disjoint AGU write footprints — see
    ``core.multistream``) runs on its assigned cluster at the derated
    practical rates with double-buffered DMA/compute overlap, so the
    parallel time is the critical path: the most-loaded cluster. The
    DMA-overlap gain is how much the per-cluster double buffering hides —
    the mechanism behind the paper's 87%-of-peak utilisation.
    """
    from repro_torch.core.multistream import ClusterScheduler
    sched = ClusterScheduler(descs, n_clusters=n_clusters, spec=spec,
                             setup_cycles=setup_cycles)
    t_serial = sum(sched.costs)
    cluster_t = sched.cluster_times()
    t_par = max(cluster_t) if cluster_t else 0.0
    t_no_overlap = sum(
        s.roofline_time(spec, setup_cycles, overlap=False)
        for s in sched.substreams)
    return {"n_substreams": float(len(sched.substreams)),
            "n_clusters": float(sched.n_clusters),
            "time_serial_s": t_serial,
            "time_parallel_s": t_par,
            "speedup": _ratio(t_serial, t_par),
            "load_balance": (min(t for t in cluster_t if t > 0) / t_par
                             if t_par > 0 and any(cluster_t) else 1.0),
            "dma_overlap_gain": _ratio(t_no_overlap, t_serial),
            "cluster_times_s": cluster_t}


# ----------------------------------------------------------------------
# Stage-pipelined dependent streams (inter-cluster handoffs)
# ----------------------------------------------------------------------
def pipeline_gain(descs, n_clusters: int = 4,
                  spec: NtxClusterSpec = PAPER_CLUSTER,
                  setup_cycles: int = 100) -> Dict[str, float]:
    """Price a DEPENDENT descriptor program executed as a stage pipeline
    (``core.multistream.StageSchedule``) vs. one serial stream.

    The program's pipeline nodes level-ize into stages; each stage runs its
    nodes concurrently (LPT over the mesh), so the pipelined time is the
    sum of per-stage critical paths plus the inter-cluster handoff DMA —
    each cross-cluster dependency edge moves the producer's write span
    into the consumer cluster's window through the shared L2 at the
    derated practical bandwidth. Consumers co-located with their producer
    hand off through the cluster's own TCDM for free.

    All ratios are guarded: an empty program or zero critical path prices
    as 1.0 (no inf/nan).
    """
    from repro_torch.core.multistream import StageSchedule
    ss = StageSchedule(descs, n_clusters=n_clusters, spec=spec,
                       setup_cycles=setup_cycles)
    t_serial = sum(ss.costs)
    stage_t = ss.stage_times()
    t_handoff = ss.handoff_time()
    t_pipe = ss.model_time()
    t_over = ss.model_time(overlap=True)
    return {"n_nodes": float(len(ss.nodes)),
            "n_edges": float(len(ss.node_edges)),
            "n_stages": float(len(ss.stages)),
            "n_clusters": float(ss.n_clusters),
            "time_serial_s": t_serial,
            "time_pipeline_s": t_pipe,
            "time_pipeline_overlap_s": t_over,
            "time_handoff_s": t_handoff,
            "time_handoff_exposed_s": ss.overlap_handoff_time(),
            "handoff_bytes": float(ss.stats["handoff_bytes"]),
            "handoff_bytes_cross": float(ss.stats["handoff_bytes_cross"]),
            "speedup": _ratio(t_serial, t_pipe),
            "overlap_speedup": _ratio(t_serial, t_over),
            "stage_times_s": stage_t}


# ----------------------------------------------------------------------
# Out-of-core tiling (§II-E double buffering / §IV overlap roofline)
# ----------------------------------------------------------------------
def tiling_gain(descs, mem: Optional[NtxMemSpec] = None,
                spec: NtxClusterSpec = PAPER_CLUSTER,
                setup_cycles: int = 100) -> Dict[str, float]:
    """Price a descriptor program streamed through TCDM tiles
    (``core.tiling.TilePlan``), double-buffered vs. not.

    Per tile the DMA pays latency + bytes/bandwidth each way and the
    engines pay flops at the derated practical rate plus the per-command
    offload setup. Without a DMA engine the three phases add
    (``time_tiled_serial_s``); with double buffering the steady-state
    tile costs max(compute, dma) and only the first tile's DMA-in is
    exposed (``time_tiled_overlap_s``) — the §IV roofline the Executor's
    auto policy consults, and the model the ``tiling`` benchmark section
    checks against measured ratios.

    ``fits`` reports whether tiling was needed at all: a program whose
    working set exceeds ``mem.tcdm_bytes`` cannot faithfully run under
    any resident policy.
    """
    from repro_torch.core.memory import working_set_bytes
    from repro_torch.core.tiling import TilePlan
    if mem is None:
        mem = NtxMemSpec.from_cluster(spec)
    ws_early = working_set_bytes(descs, mem.elem_bytes)
    if ws_early <= mem.tcdm_bytes:
        # resident program: the capacity verdict is all the auto policy
        # needs — don't pay for a tile rewrite that would be discarded
        return {"fits": 1.0,
                "working_set_bytes": float(ws_early),
                "capacity_bytes": float(mem.tcdm_bytes),
                "n_tiles": 0.0, "n_spill_items": 0.0, "dma_bytes": 0.0,
                "time_tiled_serial_s": 0.0, "time_tiled_overlap_s": 0.0,
                "speedup": 1.0}
    plan = TilePlan(descs, mem)
    setup = setup_cycles / spec.ntx_freq_hz
    t_serial = 0.0
    t_overlap = 0.0
    for tile in plan.tiles:
        tc = tile.flops() / spec.practical_flops + setup
        td_in = mem.dma_time_s(tile.in_bytes) if tile.in_bytes else 0.0
        td_out = mem.dma_time_s(tile.out_bytes) if tile.out_bytes else 0.0
        t_serial += td_in + tc + td_out
        t_overlap += max(tc, td_in + td_out)
    if plan.tiles:
        first = plan.tiles[0]
        t_overlap += mem.dma_time_s(first.in_bytes) if first.in_bytes else 0.0
    return {"fits": 0.0,
            "working_set_bytes": float(ws_early),
            "capacity_bytes": float(mem.tcdm_bytes),
            "n_tiles": float(plan.stats["n_tiles"]),
            "n_spill_items": float(plan.stats["n_spill_items"]),
            "dma_bytes": float(plan.stats["dma_in_bytes"]
                               + plan.stats["dma_out_bytes"]),
            "time_tiled_serial_s": t_serial,
            "time_tiled_overlap_s": t_overlap,
            "speedup": _ratio(t_serial, t_overlap)}


# ----------------------------------------------------------------------
# Policy pricing: everything the Executor's auto policy consults
# ----------------------------------------------------------------------
def policy_gains(descs, n_clusters: int = 4,
                 spec: NtxClusterSpec = PAPER_CLUSTER,
                 setup_cycles: int = 100,
                 mem: Optional[NtxMemSpec] = None
                 ) -> Dict[str, Dict[str, float]]:
    """All four gain ratios for one descriptor program.

    ``repro_torch.core.executor.Executor`` consults this to auto-select among
    serial, fused-stream, multistream, stage-pipeline and tiled
    execution: the fusion speedup is priced against one-command-at-a-time
    dispatch, and the two mesh gains are priced against the fused
    sub-streams they schedule — so a policy's total score vs. serial
    dispatch composes as ``fusion * mesh`` (see
    ``Executor.select_policy``). The ``tiling`` entry carries the
    capacity verdict: when ``tiling["fits"]`` is 0 the resident policies
    are unfaithful to the machine and the Executor routes through
    ``core.tiling.TilePlan`` regardless of the other scores.
    """
    return {
        "fusion": stream_fusion_gain(descs, spec=spec,
                                     setup_cycles=setup_cycles),
        "multistream": multistream_gain(descs, n_clusters=n_clusters,
                                        spec=spec,
                                        setup_cycles=setup_cycles),
        "pipeline": pipeline_gain(descs, n_clusters=n_clusters, spec=spec,
                                  setup_cycles=setup_cycles),
        "tiling": tiling_gain(descs, mem=mem, spec=spec,
                              setup_cycles=setup_cycles),
    }


# ----------------------------------------------------------------------
# Paper headline claims (tested in tests/test_perfmodel.py)
# ----------------------------------------------------------------------
def peak_utilization_bound(spec=PAPER_CLUSTER) -> float:
    """'up to 87% of peak' — the banking-conflict bound."""
    return spec.practical_flops / spec.peak_flops


def table1_figures(spec=PAPER_CLUSTER) -> Dict[str, float]:
    return {
        "peak_gflops": spec.peak_flops / 1e9,
        "peak_bw_gbs": spec.peak_bw / 1e9,
        "practical_gflops": spec.practical_flops / 1e9,
        "power_w": spec.power_w,
        "efficiency_gflops_per_w": spec.peak_flops / spec.power_w / 1e9,
        "pj_per_flop": spec.pj_per_flop,
        "area_mm2": spec.area_mm2,
    }

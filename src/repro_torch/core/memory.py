"""The cluster memory hierarchy: TCDM capacity, DMA bandwidth, HBM latency.

Counterpart of ``repro.core.memory``. On the paper's cluster (§II) every
working set the NTX FPUs touch is staged through a small banked TCDM,
two buffers deep, so the DMA copies tile i+1 in while the engines
stream tile i. :class:`NtxMemSpec` models that cluster (64 KiB of TCDM
as taped out), not the card the port runs on: the capacity decision of
the Executor's ``auto`` policy (``working_set_*``/``fits``) and the
tiles of :class:`~repro_torch.core.tiling.TilePlan` are the paper
machine's, so they match the reference's on the same program.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .cluster import NtxClusterSpec, PAPER_CLUSTER
from .descriptor import Descriptor

Span = Tuple[int, int]

_ELEM_BYTES = 4


@dataclasses.dataclass(frozen=True)
class NtxMemSpec:
    """One cluster's memory hierarchy (paper Table I + §II-E).

    ``tcdm_bytes``/``tcdm_banks``  the scratchpad every operand streams
                                   through (64 KiB, 32 banks as taped out).
    ``dma_bytes_per_cycle``        the DMA engine's AXI port width.
    ``dma_freq_hz``                the clock that port runs at.
    ``hbm_latency_s``              per-transfer latency of the backing
                                   memory the DMA hides.
    ``elem_bytes``                 fp32 stream element size.
    """

    tcdm_bytes: int = PAPER_CLUSTER.tcdm_bytes
    tcdm_banks: int = PAPER_CLUSTER.tcdm_banks
    dma_bytes_per_cycle: int = PAPER_CLUSTER.axi_bytes_per_cycle
    dma_freq_hz: float = PAPER_CLUSTER.cluster_freq_hz
    hbm_latency_s: float = 100e-9
    elem_bytes: int = _ELEM_BYTES

    def __post_init__(self):
        if self.tcdm_bytes < 2 * self.elem_bytes:
            raise ValueError(f"tcdm_bytes {self.tcdm_bytes} cannot hold a "
                             f"double-buffered element")
        if self.elem_bytes < 1:
            raise ValueError(f"elem_bytes must be >= 1, got {self.elem_bytes}")

    @classmethod
    def from_cluster(cls, spec: NtxClusterSpec, **overrides) -> "NtxMemSpec":
        """The memory hierarchy implied by a cluster spec."""
        kw = dict(tcdm_bytes=spec.tcdm_bytes, tcdm_banks=spec.tcdm_banks,
                  dma_bytes_per_cycle=spec.axi_bytes_per_cycle,
                  dma_freq_hz=spec.cluster_freq_hz)
        kw.update(overrides)
        return cls(**kw)

    @property
    def capacity_elems(self) -> int:
        return self.tcdm_bytes // self.elem_bytes

    @property
    def dma_bw(self) -> float:
        """DMA bandwidth in bytes/s (5 GB/s for the paper cluster)."""
        return self.dma_bytes_per_cycle * self.dma_freq_hz

    @property
    def buffer_budget_elems(self) -> int:
        """Elements ONE tile may occupy: half the TCDM, because every
        operand is double-buffered (tile i computes in one bank while the
        DMA fills the other)."""
        return max(1, self.capacity_elems // 2)

    def dma_time_s(self, nbytes: int) -> float:
        """One DMA transfer: latency + bandwidth term."""
        return self.hbm_latency_s + nbytes / self.dma_bw

    def smem_block_elems(self, n_streams: int, align: int = 4,
                         max_block: int = 4096) -> int:
        """Elements per operand stream of a thread block's shared-memory
        staging sized like a TCDM tile: the double-buffered budget split
        over ``n_streams`` streams, rounded down to whole 16-byte vectors
        (``align`` fp32 elements, at least one vector), at most
        ``max_block``. No port kernel reads it today: ``ntx_stream.cu``
        streams through registers and splits rows into fixed
        4096-element chunks (``kChunk``); a kernel that stages operands
        in shared memory sized like the paper's TCDM would."""
        per_stream = self.buffer_budget_elems // max(1, n_streams)
        block = max(align, (per_stream // align) * align)
        return min(block, max_block)


#: the paper's 22FDX cluster hierarchy — the process-wide default
PAPER_MEM = NtxMemSpec()


# ----------------------------------------------------------------------
# Working-set analysis
# ----------------------------------------------------------------------
def working_set_spans(descs: Sequence[Descriptor]) -> List[Span]:
    """Merged [lo, hi) element spans a program touches (reads + writes) —
    the conservative AGU footprint, same accounting as the dependency
    analysis in ``core.stream``."""
    from .stream import desc_spans, merge_spans
    spans: List[Span] = []
    for d in descs:
        reads, write = desc_spans(d)
        spans.extend(reads)
        spans.append(write)
    return merge_spans(spans)


def working_set_elems(descs: Sequence[Descriptor]) -> int:
    return sum(hi - lo for lo, hi in working_set_spans(descs))


def working_set_bytes(descs: Sequence[Descriptor],
                      elem_bytes: int = _ELEM_BYTES) -> int:
    return elem_bytes * working_set_elems(descs)


def fits(descs: Sequence[Descriptor],
         mem: NtxMemSpec = PAPER_MEM) -> bool:
    """True iff the program's whole working set is TCDM-resident — the
    assumption every non-tiled execution policy makes. When this is
    False the Executor's auto policy routes through
    :class:`~repro_torch.core.tiling.TilePlan` instead."""
    return working_set_bytes(descs, mem.elem_bytes) <= mem.tcdm_bytes

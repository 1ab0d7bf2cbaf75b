"""The cluster memory hierarchy: TCDM capacity, DMA bandwidth, HBM latency.

Counterpart of ``repro.core.memory``, as far as the executor needs it:
the :class:`NtxMemSpec` an :class:`~repro_torch.core.executor.ExecutionPolicy`
carries. The working-set analysis and the tiled policy that consult it
come with ROADMAP slice C.
"""
from __future__ import annotations

import dataclasses

from .cluster import NtxClusterSpec, PAPER_CLUSTER

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


#: the paper's 22FDX cluster hierarchy — the process-wide default
PAPER_MEM = NtxMemSpec()

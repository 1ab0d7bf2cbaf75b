"""The paper's NTX cluster, as far as the executor needs it.

Counterpart of ``repro.core.cluster`` without its TPU chip spec: the
port's device is described by the card it runs on, not by constants.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NtxClusterSpec:
    """One NTX processing cluster as taped out in 22FDX (paper Table I)."""

    n_ntx: int = 8
    ntx_freq_hz: float = 1.25e9
    cluster_freq_hz: float = 0.625e9          # RISC-V + AXI at half speed
    tcdm_bytes: int = 64 * 1024
    tcdm_banks: int = 32
    icache_bytes: int = 2 * 1024
    axi_bytes_per_cycle: int = 8               # 64-bit AXI port
    bank_conflict_prob: float = 0.13           # measured in simulation (§III-C)
    area_mm2: float = 0.51
    power_w: float = 0.186                     # typical, 3x3 conv workload
    flops_per_ntx_cycle: int = 2               # one FMAC per cycle

    @property
    def peak_flops(self) -> float:             # 20 Gflop/s
        return self.n_ntx * self.ntx_freq_hz * self.flops_per_ntx_cycle

    @property
    def peak_bw(self) -> float:                # 5 GB/s
        return self.axi_bytes_per_cycle * self.cluster_freq_hz


PAPER_CLUSTER = NtxClusterSpec()

"""The paper's NTX cluster and its scaled multi-cluster configurations.

Counterpart of ``repro.core.cluster`` without its TPU chip spec: the
port's device is described by the card it runs on, not by constants.
These are the constants the perf model and the schedulers price with.
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

    @property
    def practical_flops(self) -> float:        # ~17.4 Gflop/s (87% of peak)
        return self.peak_flops * (1.0 - self.bank_conflict_prob)

    @property
    def practical_bw(self) -> float:           # ~4.35 GB/s
        return self.peak_bw * (1.0 - self.bank_conflict_prob)

    @property
    def efficiency_flops_per_w(self) -> float:
        return self.peak_flops / self.power_w

    @property
    def pj_per_flop(self) -> float:
        return self.power_w / self.peak_flops * 1e12


PAPER_CLUSTER = NtxClusterSpec()


def ntx_multi_cluster(n_clusters: int, node_nm: int = 22) -> dict:
    """The paper's scaled configurations (Table II, NTX 16x..512x).

    Frequencies and area per cluster count are the paper's published
    table; peak flop/s is the paper's reported aggregate (the >= 128
    configurations stack dies, so it is not clusters x 8 NTX x 2 x freq).
    """
    freqs = ({16: 2.50e9, 32: 1.90e9, 64: 1.43e9} if node_nm == 22 else
             {16: 3.50e9, 32: 2.66e9, 64: 1.88e9, 128: 0.94e9,
              256: 0.47e9, 512: 0.23e9})
    peak = ({16: 0.640e12, 32: 0.973e12, 64: 1.466e12} if node_nm == 22
            else {16: 0.896e12, 32: 1.362e12, 64: 1.920e12,
                  128: 1.920e12, 256: 1.920e12, 512: 1.920e12})
    area = ({16: 4.8, 32: 9.6, 64: 19.3} if node_nm == 22 else
            {16: 1.9, 32: 3.9, 64: 7.7, 128: 15.4, 256: 30.8, 512: 61.6})
    return {"n_clusters": n_clusters, "node_nm": node_nm,
            "freq_hz": freqs[n_clusters], "peak_flops": peak[n_clusters],
            "area_mm2": area[n_clusters]}

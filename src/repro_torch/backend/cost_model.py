"""Calibrated §4.1 cost model (extracted from ``repro_torch.core.cluster``).

Disk and network are replaced by calibrated bandwidths (the paper's
testbed was 8 workers + 1 coordinator on HDD + GbE); algorithmic
quantities — bytes scanned, bytes shipped, cache contents, chunk counts,
plan times — are exact, and wall-clock is modeled as

    t(query) = max_n scan_n + max_n net_n + max_n compute_n + t_opt

with scan_n = scanned_bytes/disk_bw + decoded_cells/decode_rate(fmt),
net_n = max(bytes_in, bytes_out)/net_bw (full-duplex switch), and
compute_n = assigned cell-pair work / pair_rate. Defaults follow §4.1:
125 MB/s disk and network. A TPU-pod profile (PCIe host link + ICI) is
provided for the framework-integration experiments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


def _default_decode_rates() -> Dict[str, float]:
    """The per-format decode throughputs from ``repro_torch.arrayio.formats``
    (imported lazily — the backend package must not import the arrayio
    package at module level, which would close an import cycle through
    ``repro_torch.core``)."""
    from repro_torch.arrayio.formats import DECODE_CELLS_PER_SEC
    return dict(DECODE_CELLS_PER_SEC)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibrated per-node bandwidths/rates for the §4.1 time model."""

    disk_bw: float = 125e6               # B/s  (§4.1: HDD ~ GbE)
    net_bw: float = 125e6                # B/s per node link
    cell_pairs_per_sec: float = 5e8      # join predicate throughput per node
    decode_rates: Dict[str, float] = dataclasses.field(
        default_factory=_default_decode_rates)

    @staticmethod
    def tpu_pod_host() -> "CostModel":
        """v5e-host profile: raw shards on host NVMe/DRAM, PCIe to device,
        ICI between pods' hosts (DESIGN.md hardware-adaptation notes)."""
        return CostModel(disk_bw=3.2e9, net_bw=50e9, cell_pairs_per_sec=2e11,
                         decode_rates={k: v * 50 for k, v in
                                       _default_decode_rates().items()})

"""Roofline terms of one step on an H100, from the per-chip cost the
dry-run counts.

The port of ``repro/launch/roofline.py``, with an NVIDIA H100 in place
of the TPU v5e. Terms, in seconds per step, per chip:

  compute    = flops / peak_flops
  memory     = bytes / hbm_bw
  collective = sum over mesh axes of that axis's collective bytes over
               its link rate (:meth:`Hardware.axis_link_bw`)
  serial     = kernel launches x the host's cost of one launch

``flops``, ``bytes``, collective bytes and launches come from
``op_analysis`` (per chip, on local shards). ``model_flops`` is
6 N_active D (train) or 2 N_active D (prefill, per-token decode), so
model_flops / (flops x chips) exposes remat, dispatch and redundancy
waste.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch.op_analysis import Cost


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One chip and its links.

    ``link_bw`` serves a mesh axis that fits in one node (at most
    ``node_size`` chips, all joined by NVLink); ``node_link_bw`` serves a
    wider axis, which spans nodes and runs over each GPU's network card.
    On the production meshes every axis is 16 wide, so both ``data`` and
    ``model`` (and ``pod``, 2 wide but between pods) are charged as
    spanning nodes; a one-node mesh of up to 8 cards gets NVLink."""
    name: str = "h100_sxm"
    # NVIDIA H100 SXM5 data sheet (700 W): dense BF16 tensor core rate.
    peak_flops: float = 989e12
    # Same data sheet: HBM3 bandwidth, 3.35 TB/s.
    hbm_bw: float = 3.35e12
    # NVLink 4: 900 GB/s bidirectional per GPU, so 450 GB/s a direction.
    link_bw: float = 450e9
    # One 400 Gb/s NIC per GPU (ConnectX-7, the DGX H100 layout): 50 GB/s.
    node_link_bw: float = 50e9
    # GPUs per NVLink node (DGX / HGX H100).
    node_size: int = 8
    # Same data sheet: 80 GB of HBM3.
    hbm_bytes: float = 80e9
    # Host cost of one eager kernel launch, s: the median that
    # ``chip_smoke.py``'s launch-roofline phase measured over a stream of
    # 20,000 tiny ops on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6).
    loop_latency: float = 8.3343e-6

    def axis_link_bw(self, axis_size: int) -> float:
        """Link rate of a mesh axis of ``axis_size`` chips: NVLink within
        a node, the network card beyond it."""
        return self.link_bw if axis_size <= self.node_size \
            else self.node_link_bw


H100 = Hardware()


@dataclasses.dataclass
class RooflineReport:
    """One cell's per-chip counts, terms and ratios (the reference's
    fields)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    serial_s: float
    seq_iters: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    hbm_per_chip: Optional[float] = None
    coll_by_kind: Optional[Dict[str, float]] = None

    @property
    def step_time_s(self) -> float:
        """Max-of-terms roofline step time (perfect overlap); the serial
        floor cannot be overlapped away."""
        return max(self.compute_s, self.memory_s, self.collective_s,
                   self.serial_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline step: how close the
        step is to running the model's math at the H100's peak."""
        if self.step_time_s <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * H100.peak_flops)
        return min(1.0, ideal / self.step_time_s)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The model's own FLOPs for one step of ``shape``: 6 N_active D for
    training, 2 N_active D for a prefill, and for decode 2 N_active plus
    the attention over the whole KV cache per sequence."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads the whole KV cache —
    # counted via 2·N_active plus 2·KV flops per layer.
    kv_layers = sum(1 for m, _ in cfg.layer_pattern if m == "attn") * \
        cfg.n_periods
    hd = cfg.resolved_head_dim
    kv_flops = 4.0 * shape.seq_len * cfg.n_heads * hd * kv_layers
    return (2.0 * n_active + kv_flops) * shape.global_batch


def collective_seconds(cost: Cost, axis_sizes: Mapping[str, int],
                       hw: Hardware = H100) -> float:
    """Collective bytes over each axis's link rate; bytes on no known
    axis are charged at the slower, between-node rate."""
    seconds = 0.0
    placed = 0.0
    for axis, b in cost.coll_by_axis.items():
        if axis in axis_sizes:
            seconds += b / hw.axis_link_bw(axis_sizes[axis])
            placed += b
    return seconds + (cost.coll_bytes - placed) / hw.node_link_bw


def build_report(arch: str, shape_cfg: ShapeConfig, mesh_name: str,
                 chips: int, cost: Cost, cfg: ModelConfig,
                 hbm_per_chip: Optional[float] = None,
                 hw: Hardware = H100,
                 axis_sizes: Optional[Mapping[str, int]] = None
                 ) -> RooflineReport:
    """The report of one cell from its per-chip ``cost``; ``axis_sizes``
    (mesh axis -> chips) picks each collective's link rate."""
    compute = cost.flops / hw.peak_flops
    memory = cost.bytes / hw.hbm_bw
    coll = collective_seconds(cost, axis_sizes or {}, hw)
    serial = cost.seq_iters * hw.loop_latency
    mf = model_flops(cfg, shape_cfg)
    useful = mf / max(cost.flops * chips, 1.0)
    terms = {"compute": compute, "memory": memory, "collective": coll,
             "serial": serial}
    bottleneck = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
        coll_bytes_per_chip=cost.coll_bytes, compute_s=compute,
        memory_s=memory, collective_s=coll, serial_s=serial,
        seq_iters=cost.seq_iters, model_flops=mf,
        useful_ratio=useful, bottleneck=bottleneck,
        hbm_per_chip=hbm_per_chip,
        coll_by_kind=dict(cost.coll_by_kind))


def format_row(r: RooflineReport) -> str:
    """One aligned line of a report."""
    return (f"{r.arch:<22} {r.shape:<12} {r.mesh:<10} "
            f"C={r.compute_s:9.3e}s M={r.memory_s:9.3e}s "
            f"X={r.collective_s:9.3e}s S={r.serial_s:9.3e}s "
            f"dom={r.bottleneck:<10} "
            f"useful={r.useful_ratio:6.1%} roofline={r.roofline_fraction:6.1%}")

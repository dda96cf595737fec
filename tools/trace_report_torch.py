#!/usr/bin/env python
"""Render a telemetry trace of the PyTorch/CUDA port as a per-phase /
per-node text breakdown.

The port's counterpart of ``trace_report.py``: runs the same seeded Zipf
workload (the ``smoke_mqo`` recipe, with reuse, MQO, the result cache
and hot replication on) through a ``telemetry="on"`` ``repro_torch``
cluster — by default on the card (``backend="torch_device"``, the CUDA
simjoin kernels) — and prints

  * a **per-phase** table — one row per span name (``plan.scan``,
    ``policy.evict``, ``dispatch``, ...) with call count, total/mean
    duration, and share of the root ``workload`` span's wall-clock;
  * a **per-node** table — simjoin work and cache health by node, read
    from the registry's ``cache.budget_utilization`` gauges and the
    per-node span args;
  * the registry summary (every ``workload_summary`` counter, straight
    from the live registry),

and writes the Chrome trace-event JSON artifact (default
``workload.trace.json``) for Perfetto / ``chrome://tracing``. The
device, the backend and the card's name head the report; nothing falls
back to the CPU unless ``--device cpu`` asks for it (the kernels' plain
versions).

Usage:

    PYTHONPATH=src python tools/trace_report_torch.py \
        [--backend {torch_device,simulated}] [--device {cuda,cpu}] \
        [--out workload.trace.json]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def phase_table(spans) -> str:
    """Format the per-phase breakdown table from a list of spans."""
    roots = [s for s in spans if s.parent_id is None]
    wall = sum(s.duration_s for s in roots) or 1.0
    agg = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
    for s in spans:
        agg[s.name][0] += 1
        agg[s.name][1] += s.duration_s
    lines = [f"{'phase':<18}{'count':>7}{'total_s':>10}{'mean_ms':>10}"
             f"{'% wall':>8}"]
    for name, (count, total) in sorted(agg.items(),
                                       key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<18}{count:>7}{total:>10.4f}"
                     f"{1e3 * total / count:>10.3f}"
                     f"{100.0 * total / wall:>7.1f}%")
    return "\n".join(lines)


def node_table(spans, registry) -> str:
    """Format the per-node breakdown from span args and gauges."""
    per_node = defaultdict(lambda: [0, 0.0])  # node -> [spans, total_s]
    for s in spans:
        node = s.args.get("node")
        if node is not None:
            per_node[node][0] += 1
            per_node[node][1] += s.duration_s
    util = {}
    for g in registry.as_dict().get("gauges", []):
        if g["name"] == "cache.budget_utilization":
            util[g["labels"].get("node")] = g["value"]
    nodes = sorted(set(per_node) | set(util))
    lines = [f"{'node':<6}{'spans':>7}{'span_s':>10}{'budget_util':>13}"]
    for n in nodes:
        count, total = per_node.get(n, (0, 0.0))
        u = util.get(n)
        lines.append(f"{n!s:<6}{count:>7}{total:>10.4f}"
                     f"{('%.3f' % u if u is not None else '-'):>13}")
    return "\n".join(lines) if nodes else "(no per-node spans or gauges)"


def device_label(device: str) -> str:
    """The card's name for a CUDA device, else ``cpu``."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev.index or 0)
    return str(dev)


def main(argv=None) -> int:
    """Run the workload, print the report, write the trace artifact."""
    from repro_torch.arrayio.catalog import FileReader, build_catalog
    from repro_torch.arrayio.generator import make_geo_files
    from repro_torch.core.cluster import RawArrayCluster
    from repro_torch.core.workload import zipf_workload

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="torch_device",
                    choices=("torch_device", "simulated"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels) or cpu (their "
                         "plain versions)")
    ap.add_argument("--out", default="workload.trace.json",
                    help="path for the Chrome trace-event JSON artifact")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="trace_report_") as root:
        files = make_geo_files(n_files=3, n_seeds=120, clones_per_seed=20,
                               seed=5)
        catalog, data = build_catalog(files, root, "csv", n_nodes=4)
        budget = sum(f.n_cells * f.cell_bytes for f in catalog.files)
        reader = FileReader(catalog, data)
        queries = zipf_workload(catalog.domain, n_queries=24,
                                n_templates=6, s=1.1, eps=300,
                                field_frac=0.4, seed=7)
        cluster = RawArrayCluster(catalog, reader, 4, budget // 4,
                                  policy="cost", min_cells=512,
                                  join_backend="torch",
                                  backend=args.backend, device=args.device,
                                  reuse="on", mqo="on", result_cache="on",
                                  replication="hot", telemetry="on")
        executed = cluster.run_workload(queries, batch_size=8)

    spans = cluster.telemetry.tracer.spans
    print(f"== per-phase breakdown ({len(spans)} spans, "
          f"{len(executed)} queries, backend={args.backend}, "
          f"device={device_label(args.device)}) ==")
    print(phase_table(spans))
    print("\n== per-node breakdown ==")
    print(node_table(spans, cluster.telemetry.registry))
    print("\n== registry summary ==")
    for k, v in cluster.telemetry.registry.as_summary().items():
        print(f"  {k} = {v:g}")
    path = cluster.export_trace(args.out)
    print(f"\nwrote Chrome trace artifact: {path} "
          f"(load in Perfetto or chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

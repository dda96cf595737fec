#!/usr/bin/env python
"""The CI smoke gates and the invariant audit of the PyTorch/CUDA port.

One runner for the seven gates of the JAX package's tools, each on its
tool's own recipe (generator, seeds, file counts, budget, queries and
cluster options) through ``repro_torch``: the join backend is the port's
``"torch"`` executor where the tool asks for ``"pallas"``, and the
execution backend is ``torch_device`` (the default: cached chunks held
as int32 tensors on the card, joined by the CUDA simjoin kernels) or
``simulated``. Each gate checks its tool's invariants and prints its
tool's OK and FAIL lines:

  * ``artifact_counters`` (``smoke_artifact_counters.py``): a repeated
    GEO workload hits the join-artifact cache on its warm pass with the
    cold pass's match counts;
  * ``bitmap_prune`` (``smoke_bitmap_prune.py``): the bitmap stage kills
    bbox-surviving block pairs with ``prune="dense"``'s match counts and
    evaluates no more pairs than ``prune="block"``, whose summary keeps
    no bitmap counter;
  * ``mqo`` (``smoke_mqo.py``): shared-task and result-cache hits with
    the match counts of a run with both tiers off;
  * ``trace`` (``smoke_trace.py``): well-formed Chrome trace JSON, one
    root ``workload`` span whose children cover more than 90 % of it, the
    live registry equal to ``workload_summary``, three counter families
    engaged;
  * ``failover`` (``smoke_failover.py``): replicas form, the fullest
    node is killed halfway and recovers, match counts equal an unfailed
    single-copy run;
  * ``chaos`` (``smoke_chaos.py``): a seeded fault storm injects,
    retries and re-routes, the auditor finds nothing, completed queries
    equal a fault-free run, and the same seed gives the same schedule;
  * ``audit`` (``audit_state.py``): a GEO workload under a storm with the
    auditor armed every round finds zero violations.

Every gate is a function (:data:`GATES`) that returns a
:class:`GateResult`: each run's per-query matches, ``workload_summary``
and coordinator stats, its failures and its log lines. ``failover`` and
``chaos`` also take another :class:`Deployment` (``chip_smoke.py`` runs
them on the paper's PTF deployment). Nothing falls back: without a card,
``--device cuda`` raises; ``--device cpu`` runs the kernels' plain
versions.

Usage:

    PYTHONPATH=src python tools/smoke_torch.py [--gate NAME]
        [--backend {torch_device,simulated}] [--device {cuda,cpu}]

Exits nonzero when any gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.arrayio.catalog import FileReader, build_catalog  # noqa: E402
from repro_torch.arrayio.generator import (make_geo_files,  # noqa: E402
                                           make_ptf_files)
from repro_torch.core.cluster import (RawArrayCluster,  # noqa: E402
                                      workload_summary)
from repro_torch.core.geometry import Box  # noqa: E402
from repro_torch.core.workload import geo_workload, zipf_workload  # noqa: E402
from repro_torch.faults import (FAULT_POINTS, FaultInjector,  # noqa: E402
                                FaultSpec)

BACKENDS = ("torch_device", "simulated")

#: The chaos storm (``smoke_chaos.py``): every point at STORM_RATE with
#: all three kinds, except ``ship.transfer``, which fires errors and
#: corruptions at SHIP_RATE so retries must re-route and the checksums
#: must catch bit-flipped payloads.
STORM_RATE = 0.10
SHIP_RATE = 0.45
STORM_SEED = 1234


@dataclasses.dataclass
class Run:
    """One workload run of a gate: per-query matches and whether each
    query was served degraded, its ``workload_summary`` and the
    coordinator's stats after it."""

    matches: List[Optional[int]]
    degraded: List[bool]
    summary: Dict[str, float]
    stats: Dict[str, float]


@dataclasses.dataclass
class GateResult:
    """A gate's runs (by name, the checked run last), its failures (empty
    when it passed), the lines it printed, anything else it compared
    (``extra``: the chaos storm's ``schedule_log``, the trace's coverage)
    and its wall seconds."""

    gate: str
    runs: Dict[str, Run]
    failures: List[str]
    lines: List[str]
    extra: Dict[str, Any]
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        """Whether every invariant held."""
        return not self.failures

    @property
    def summary(self) -> Dict[str, float]:
        """The ``workload_summary`` of the run the gate checks (its last)."""
        return list(self.runs.values())[-1].summary


@dataclasses.dataclass(frozen=True)
class Deployment:
    """Where ``failover`` and ``chaos`` run: the raw files and their
    format, the cluster's nodes, per-node budget (from the catalog) and
    chunk size, the queries' eps, further cluster options, and how many
    of the gate's Zipf queries to run (``None``: all of them)."""

    files: Callable[[], list]
    fmt: str
    n_nodes: int
    node_budget: Callable[[Any], int]
    min_cells: int
    eps: int
    options: Mapping[str, Any]
    n_queries: Optional[int] = None

    def build(self, root: str) -> "Dataset":
        """Write the files under ``root`` and catalog them."""
        catalog, data = build_catalog(self.files(), root, self.fmt,
                                      n_nodes=self.n_nodes)
        return Dataset(self, catalog, data)


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A deployment's catalog and the directory its files lie in."""

    deployment: Deployment
    catalog: Any
    data: str


#: ``smoke_failover.py``'s and ``smoke_chaos.py``'s deployment (8 and 12
#: PTF files of about 700 cells, 4 nodes of 400,000 bytes); the join
#: backend is the tools' default, numpy, on the simulated backend.
FAILOVER = Deployment(
    lambda: make_ptf_files(n_files=8, cells_per_file_mean=700, seed=11),
    "fits", 4, lambda catalog: 400_000, 64, 150,
    dict(join_backend="numpy", replica_k=2, replication_threshold=2.0))
CHAOS = dataclasses.replace(
    FAILOVER, files=lambda: make_ptf_files(n_files=12,
                                           cells_per_file_mean=700,
                                           seed=11))


def dataset_bytes(catalog) -> int:
    """Bytes of every cell of the catalog's files."""
    return sum(f.n_cells * f.cell_bytes for f in catalog.files)


#: The paper's PTF deployment as ``chip_smoke.py``'s ``ptf`` phase runs
#: it: 32 skewed PTF files of 50,000 cells a file on average (2.6 M
#: cells), 8 nodes, a quarter of the dataset cached, eps 300,
#: block-sparse joins, hot replication of 2 copies; the first 8 of each
#: gate's Zipf queries (a time cut: with their plain runs on an H100 the
#: whole sequences took 94 s, 12 queries 59 s, 8 queries 39 s; at 8 the
#: crash still readmits and the storm still re-routes 11 transfers).
PTF = Deployment(
    lambda: make_ptf_files(n_files=32, cells_per_file_mean=50_000,
                           skew=1.1, seed=21),
    "hdf5", 8, lambda catalog: dataset_bytes(catalog) // 4 // 8, 8192, 300,
    dict(prune="block", replica_k=2, replication_threshold=2.0),
    n_queries=8)


def _run(cluster, queries, batch_size=None) -> Run:
    """Run a workload on ``cluster`` and record it."""
    executed = cluster.run_workload(queries, batch_size=batch_size)
    return _record(cluster, executed)


def _record(cluster, executed) -> Run:
    """A :class:`Run` of ``executed`` on ``cluster``."""
    return Run([e.matches for e in executed],
               [e.degraded is not None for e in executed],
               workload_summary(executed), dict(cluster.coordinator.stats))


def _geo(root: str, fmt: str = "csv", **kw):
    """GEO files written under ``root`` and catalogued for 4 nodes."""
    catalog, data = build_catalog(make_geo_files(**kw), root, fmt,
                                  n_nodes=4)
    return catalog, FileReader(catalog, data)


def gate_artifact_counters(root: str, backend: str = "torch_device",
                           device: str = "cuda",
                           impl: str = "kernel") -> GateResult:
    """``smoke_artifact_counters.py``: a cold and a warm pass of one GEO
    workload; the warm pass must hit the artifact cache and return the
    cold pass's match counts."""
    catalog, reader = _geo(_dir(root, "art"), n_files=3, n_seeds=120,
                           clones_per_seed=20, seed=5)
    cluster = RawArrayCluster(catalog, reader, 4,
                              dataset_bytes(catalog) // 4, policy="cost",
                              min_cells=512, join_backend="torch",
                              backend=backend, device=device, impl=impl)
    queries = geo_workload(catalog.domain, eps=300, range_frac=0.4)
    cold = _run(cluster, queries)
    warm = _run(cluster, queries)
    s = warm.summary
    lines = [f"cold matches: {cold.matches}",
             f"warm matches: {warm.matches}",
             f"warm artifact_hits={s.get('artifact_hits')} "
             f"artifact_misses={s.get('artifact_misses')} "
             f"prep_s={s.get('prep_s', 0.0):.4f} "
             f"dispatch_s={s.get('dispatch_s', 0.0):.4f}"]
    failures = []
    if s.get("artifact_hits", 0) <= 0:
        failures.append("warm pass reported no artifact hits — the join-"
                        "artifact cache is being bypassed")
    if warm.matches != cold.matches or _total(cold) <= 0:
        failures.append("warm match counts differ from cold (stale "
                        "artifact served?)")
    return _result("artifact_counters", {"cold": cold, "warm": warm},
                   failures, lines,
                   "artifact cache hit on the warm pass with bit-identical "
                   "match counts")


def gate_bitmap_prune(root: str, backend: str = "torch_device",
                      device: str = "cuda",
                      impl: str = "kernel") -> GateResult:
    """``smoke_bitmap_prune.py``: one clustered GEO workload under
    ``prune="dense"``, ``"block"`` and ``"bitmap"``."""
    catalog, reader = _geo(_dir(root, "bm"), n_files=3, n_seeds=150,
                           clones_per_seed=25, seed=13)
    budget = dataset_bytes(catalog)
    runs = {}
    for prune in ("dense", "block", "bitmap"):
        cluster = RawArrayCluster(catalog, reader, 4, budget // 8 // 4,
                                  policy="cost", min_cells=2048,
                                  join_backend="torch", backend=backend,
                                  device=device, impl=impl, prune=prune)
        runs[prune] = _run(cluster, geo_workload(catalog.domain, eps=400,
                                                 range_frac=0.45))
    dense, block, bitmap = runs["dense"], runs["block"], runs["bitmap"]
    bs, ks = bitmap.summary, block.summary
    killed = bs.get("block_pairs_bitmap_killed", 0)
    lines = [f"dense matches:  {dense.matches}",
             f"bitmap matches: {bitmap.matches}",
             f"bitmap block_pairs_evaluated="
             f"{bs.get('block_pairs_evaluated'):.0f}/"
             f"{bs.get('block_pairs_total'):.0f} "
             f"(block mode: {ks.get('block_pairs_evaluated'):.0f}) "
             f"bitmap_killed={killed:.0f} "
             f"bitmap_build_s={bs.get('bitmap_build_s', 0.0):.4f}"]
    failures = []
    if bitmap.matches != dense.matches or _total(dense) <= 0:
        failures.append("bitmap-pruned match counts differ from dense — "
                        "the cell-exact stage killed a pair containing a "
                        "real match")
    if killed <= 0:
        failures.append("block_pairs_bitmap_killed == 0 on a clustered "
                        "workload — the bitmap stage is not engaging")
    if bs.get("block_pairs_evaluated", 0) > ks.get("block_pairs_evaluated",
                                                   0):
        failures.append("bitmap mode evaluated more pairs than block mode "
                        "— refinement must only shrink pair lists")
    if "block_pairs_bitmap_killed" in ks:
        failures.append("bitmap counters leaked into a prune=\"block\" "
                        "summary — the emission group must stay gated")
    return _result("bitmap_prune", runs, failures, lines,
                   f"bitmap stage killed {killed:.0f} bbox-surviving block "
                   f"pairs with bit-identical matches vs dense ({backend} "
                   f"backend)")


def _zipf_geo(root: str, tag: str):
    """The GEO data, budget and Zipf queries of ``smoke_mqo.py`` and
    ``smoke_trace.py``."""
    catalog, reader = _geo(_dir(root, tag), n_files=3, n_seeds=120,
                           clones_per_seed=20, seed=5)
    queries = zipf_workload(catalog.domain, n_queries=24, n_templates=6,
                            s=1.1, eps=300, field_frac=0.4, seed=7)
    return catalog, reader, dataset_bytes(catalog), queries


def gate_mqo(root: str, backend: str = "torch_device",
             device: str = "cuda", impl: str = "kernel") -> GateResult:
    """``smoke_mqo.py``: a Zipf repeat workload in batches of 8 with
    ``mqo``/``result_cache`` off, then on; the second run must share
    tasks, hit the result tier and return the first run's matches."""
    catalog, reader, budget, queries = _zipf_geo(root, "mqo")

    def build(mqo: str, rc: str) -> RawArrayCluster:
        return RawArrayCluster(catalog, reader, 4, budget // 4,
                               policy="cost", min_cells=512,
                               join_backend="torch", backend=backend,
                               device=device, impl=impl, mqo=mqo,
                               result_cache=rc)

    reference = _run(build("off", "off"), queries, batch_size=8)
    cluster = build("on", "on")
    optimized = _run(cluster, queries, batch_size=8)
    s, stats = optimized.summary, optimized.stats
    lines = [f"reference matches: {reference.matches}",
             f"optimized matches: {optimized.matches}",
             f"mqo_tasks_total={s.get('mqo_tasks_total')} "
             f"mqo_tasks_executed={s.get('mqo_tasks_executed')} "
             f"mqo_shared_hits={s.get('mqo_shared_hits')} "
             f"result_cache_hits={stats['result_cache_hits']} "
             f"result_cache_misses={stats['result_cache_misses']} "
             f"planner_invocations="
             f"{cluster.coordinator.planner_invocations}"]
    failures = []
    if s.get("mqo_shared_hits", 0) <= 0:
        failures.append("no shared task hits — cross-batch dedup is being "
                        "bypassed")
    if stats["result_cache_hits"] <= 0:
        failures.append("no result-cache hits — repeat queries are being "
                        "re-planned")
    if optimized.matches != reference.matches or _total(reference) <= 0:
        failures.append("optimized match counts differ from the reference "
                        "(bad fan-out or stale result served?)")
    return _result("mqo", {"reference": reference, "optimized": optimized},
                   failures, lines, "shared-task + result-cache hits with "
                   "bit-identical match counts")


def gate_trace(root: str, backend: str = "torch_device",
               device: str = "cuda", impl: str = "kernel") -> GateResult:
    """``smoke_trace.py``: the Zipf workload with reuse, MQO, the result
    cache, hot replication and telemetry on; checks the Chrome trace it
    exports (``<root>/trace_out/workload.trace.json``), the root span's
    coverage and the live registry."""
    catalog, reader, budget, queries = _zipf_geo(root, "trace")
    cluster = RawArrayCluster(catalog, reader, 4, budget // 4,
                              policy="cost", min_cells=512,
                              join_backend="torch", backend=backend,
                              device=device, impl=impl, reuse="on",
                              mqo="on", result_cache="on",
                              replication="hot", telemetry="on")
    executed = cluster.run_workload(queries, batch_size=8)
    run = _record(cluster, executed)
    failures: List[str] = []
    lines: List[str] = []
    extra: Dict[str, Any] = {}
    path = os.path.join(_dir(root, "trace_out"), "workload.trace.json")
    cluster.export_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        failures.append("exported trace has no traceEvents list")
        events = []
    complete = [e for e in events if e.get("ph") == "X"]
    bad = [e for e in complete
           if not (isinstance(e.get("ts"), (int, float))
                   and isinstance(e.get("dur"), (int, float))
                   and e.get("dur") >= 0 and e.get("name"))]
    if not complete or bad:
        failures.append(f"malformed complete events in trace: {bad[:3]}")
    spans = cluster.telemetry.tracer.spans
    roots = [s for s in spans if s.parent_id is None]
    coverage = 0.0
    if len(roots) != 1 or roots[0].name != "workload":
        failures.append(f"expected one root 'workload' span, got "
                        f"{[(s.name, s.parent_id) for s in roots]}")
    else:
        root_span = roots[0]
        children = [s for s in spans if s.parent_id == root_span.span_id]
        coverage = (sum(c.duration_s for c in children)
                    / root_span.duration_s if root_span.duration_s else 0.0)
        lines.append(f"spans={len(spans)} trace_events={len(events)} "
                     f"root_duration_s={root_span.duration_s:.4f} "
                     f"coverage={coverage:.4f}")
        if coverage <= 0.90:
            failures.append(f"direct children of the workload span cover "
                            f"only {coverage:.1%} of its wall-clock "
                            f"(phases escaping the span stack?)")
    extra["coverage"] = coverage
    legacy = run.summary
    live = cluster.telemetry.registry.as_summary()
    missing = [k for k in legacy if k not in live]
    drift = {k: (legacy[k], live[k]) for k in legacy
             if k in live and live[k] != legacy[k]}
    extra_keys = [k for k in live if k not in legacy]
    if missing or drift or extra_keys:
        failures.append(f"registry/summary divergence — missing={missing} "
                        f"drift={drift} extra={extra_keys}")
    engaged = [k for k in ("reuse_hits", "mqo_shared_hits",
                           "result_cache_hits", "replica_hits")
               if legacy.get(k, 0) > 0]
    extra["engaged"] = engaged
    lines.append(f"summary keys={len(legacy)} engaged_counters={engaged}")
    if len(engaged) < 3:
        failures.append(f"mixed workload did not engage enough counter "
                        f"families (got {engaged}) — smoke lost its teeth")
    return _result("trace", {"traced": run}, failures, lines,
                   "valid Chrome trace, >90% span coverage, registry "
                   "totals match workload_summary", extra)


def _cluster(dataset: Dataset, backend: str, device: str, impl: str,
             **kw) -> RawArrayCluster:
    """A cluster over a deployment's dataset with its options, ``kw``
    on top."""
    dep = dataset.deployment
    catalog = dataset.catalog
    return RawArrayCluster(catalog, FileReader(catalog, dataset.data),
                           dep.n_nodes, dep.node_budget(catalog),
                           policy="cost", min_cells=dep.min_cells,
                           backend=backend, device=device, impl=impl,
                           **{**dep.options, **kw})


def fullest_node(cluster) -> int:
    """The node holding the most cached bytes (the lowest id on ties)."""
    chunk_bytes, _ = cluster.coordinator.chunks.size_tables()
    by_node = cluster.coordinator.cache.bytes_by_node(chunk_bytes)
    return max(by_node, key=lambda n: (by_node[n], -n))


def gate_failover(root: str, backend: str = "torch_device",
                  device: str = "cuda", impl: str = "kernel",
                  dataset: Optional[Dataset] = None) -> GateResult:
    """``smoke_failover.py``: a Zipf repeat workload in batches of 3
    through a single-copy cluster, then through a hot-replicated one
    whose fullest node is killed halfway. ``dataset`` (default: the
    tool's own, :data:`FAILOVER`) may be another deployment's."""
    dataset = dataset or FAILOVER.build(_dir(root, "failover"))
    queries = zipf_workload(dataset.catalog.domain, n_queries=18,
                            n_templates=3, s=1.5, eps=dataset.deployment.eps,
                            field_frac=0.25, seed=3)
    queries = queries[:dataset.deployment.n_queries]
    reference = _run(_cluster(dataset, backend, device, impl,
                              replication="off"), queries, batch_size=3)
    cluster = _cluster(dataset, backend, device, impl, replication="hot")
    half = len(queries) // 2
    executed = cluster.run_workload(queries[:half], batch_size=3)
    replicated = sum(len(reps) > 1
                     for _, reps in cluster.coordinator.cache.location_items())
    victim = fullest_node(cluster)
    event = cluster.fail_node(victim)
    executed += cluster.run_workload(queries[half:], batch_size=3)
    run = _record(cluster, executed)
    s = run.summary
    lines = [f"replicated chunks before kill: {replicated}",
             f"killed node {victim}: readmits={event['failover_readmits']} "
             f"from_replica={event['recovery_bytes_from_replica']} "
             f"from_raw={event['recovery_bytes_from_raw']} "
             f"recovery_s={event['recovery_s']:.4f}",
             f"summary failover_readmits={s.get('failover_readmits')} "
             f"replica_hits={s.get('replica_hits')}"]
    failures = []
    if replicated <= 0:
        failures.append("no chunk held >1 replica before the kill — the "
                        "replication round never promoted")
    if s.get("failover_readmits", 0) <= 0:
        failures.append("failover_readmits == 0 — the recovery path is dead")
    if run.matches != reference.matches or _total(reference) <= 0:
        failures.append("match counts differ from the unfailed single-copy "
                        "reference (stale/partial results after failover?)")
    extra = {"victim": victim, "replicated": replicated}
    return _result("failover", {"reference": reference, "failed": run},
                   failures, lines, "replicas formed, node killed and "
                   "recovered, bit-identical match counts", extra)


def build_storm() -> FaultInjector:
    """The chaos gate's seeded storm (:data:`STORM_RATE`,
    :data:`SHIP_RATE`, :data:`STORM_SEED`)."""
    specs = [FaultSpec("ship.transfer", SHIP_RATE,
                       kinds=("error", "corrupt"))]
    specs += [FaultSpec(p, STORM_RATE, kinds=("error", "latency", "corrupt"))
              for p in FAULT_POINTS if p != "ship.transfer"]
    return FaultInjector(specs, seed=STORM_SEED)


def gate_chaos(root: str, backend: str = "torch_device",
               device: str = "cuda", impl: str = "kernel",
               dataset: Optional[Dataset] = None,
               fail_half: bool = False) -> GateResult:
    """``smoke_chaos.py``: a Zipf repeat workload in batches of 3 through
    a hot-replicated cluster, fault-free, then twice under the same
    seeded storm. ``dataset`` (default: the tool's own, :data:`CHAOS`)
    may be another deployment's; ``fail_half`` also kills each run's
    fullest node halfway through."""
    dataset = dataset or CHAOS.build(_dir(root, "chaos"))
    queries = zipf_workload(dataset.catalog.domain, n_queries=24,
                            n_templates=3, s=1.5, eps=dataset.deployment.eps,
                            field_frac=0.5, seed=3)
    queries = queries[:dataset.deployment.n_queries]

    def run(faults):
        cluster = _cluster(dataset, backend, device, impl,
                           replication="hot", faults=faults)
        if not fail_half:
            return cluster, _run(cluster, queries, batch_size=3)
        half = len(queries) // 2
        executed = cluster.run_workload(queries[:half], batch_size=3)
        cluster.fail_node(fullest_node(cluster))
        executed += cluster.run_workload(queries[half:], batch_size=3)
        return cluster, _record(cluster, executed)

    failures: List[str] = []
    lines: List[str] = []
    _, reference = run("off")
    if any(k in reference.summary for k in ("faults_injected", "retries")):
        failures.append("faults='off' run carries fault counters — the "
                        "seed-parity gate leaks")
    cluster, storm = run(build_storm())
    s = storm.summary
    injected = s.get("faults_injected", 0)
    retries = s.get("retries", 0)
    reroutes = s.get("transfer_reroutes", 0)
    violations = s.get("audit_violations", 0)
    degraded = int(s.get("degraded_queries", 0))
    lines.append(f"storm: injected={injected} retries={retries} "
                 f"reroutes={reroutes} "
                 f"raw_fallbacks={s.get('raw_fallbacks')} "
                 f"checksum_mismatch={s.get('checksum_mismatch')} "
                 f"degraded={degraded} audit_violations={violations}")
    if injected <= 0 or retries <= 0:
        failures.append("the storm injected nothing or nothing retried — "
                        "the fault seam or retrier is dead")
    if reroutes < 1:
        failures.append("no transfer re-routed to a surviving replica")
    if violations != 0:
        failures.append("invariant auditor found violations:\n"
                        + cluster.coordinator.auditor.report())
    mismatched = [i for i, (m, want, bad) in enumerate(zip(
        storm.matches, reference.matches, storm.degraded))
        if not bad and m != want]
    if mismatched or _total(reference) <= 0:
        failures.append(f"completed queries {mismatched} differ from the "
                        f"fault-free reference (partial/corrupt results "
                        f"served as complete)")
    again_cluster, again = run(build_storm())
    schedule = list(cluster.coordinator.faults.schedule_log)
    if schedule != list(again_cluster.coordinator.faults.schedule_log):
        failures.append("same-seed storms produced different injection "
                        "schedules")
    n = len(storm.matches)
    return _result("chaos", {"reference": reference, "storm_again": again,
                             "storm": storm}, failures, lines,
                   f"storm injected+retried+re-routed, zero audit "
                   f"violations, {n - degraded}/{n} completed queries "
                   f"bit-identical, schedule reproducible",
                   {"schedule_log": schedule})


def gate_audit(root: str, backend: str = "torch_device",
               device: str = "cuda", impl: str = "kernel") -> GateResult:
    """``audit_state.py`` at its defaults: a GEO workload in batches of 2
    under a storm of rate 0.10 from seed 0 with the auditor armed every
    round, then a final audit pass; zero violations at any point."""
    catalog, reader = _geo(_dir(root, "audit"), "fits", n_files=12,
                           n_seeds=120, clones_per_seed=12,
                           domain=Box((1, 1), (4000, 2000)), seed=11)
    queries = geo_workload(catalog.domain, eps=20, seed=9)
    cluster = RawArrayCluster(catalog, reader, 4, 300_000, policy="cost",
                              min_cells=64, join_backend="numpy",
                              backend=backend, device=device, impl=impl,
                              replication="hot", replica_k=2,
                              replication_threshold=2.0,
                              faults=FaultInjector.storm(0.10, seed=0),
                              audit="on")
    half = len(queries) // 2
    executed = cluster.run_workload(queries[:half], batch_size=2)
    executed += cluster.run_workload(queries[half:], batch_size=2)
    auditor = cluster.coordinator.auditor
    final = auditor.audit()
    run = _record(cluster, executed)
    s = run.summary
    lines = [f"queries={len(executed)} matches={_total(run)} "
             f"injected={s.get('faults_injected', 0)} "
             f"retries={s.get('retries', 0)} "
             f"degraded={s.get('degraded_queries', 0)}",
             auditor.report()]
    failures = []
    if auditor.violations_total > 0:
        failures.append(f"{auditor.violations_total} invariant violation(s) "
                        f"({len(final)} in the terminal pass)")
    return _result("audit", {"audited": run}, failures, lines,
                   f"zero invariant violations across {auditor.audits_run} "
                   f"audit passes", {"audits_run": auditor.audits_run})


#: Gate name -> gate function, in the order the runner takes them.
GATES: Dict[str, Callable[..., GateResult]] = {
    "artifact_counters": gate_artifact_counters,
    "bitmap_prune": gate_bitmap_prune,
    "mqo": gate_mqo,
    "trace": gate_trace,
    "failover": gate_failover,
    "chaos": gate_chaos,
    "audit": gate_audit,
}


def _total(run: Run) -> int:
    """Matches summed over a run's queries (None counts 0)."""
    return sum(m or 0 for m in run.matches)


def _dir(root: str, tag: str) -> str:
    """The directory ``tag`` under ``root`` for a gate's files."""
    path = os.path.join(root, tag)
    os.makedirs(path, exist_ok=True)
    return path


def _result(gate, runs, failures, lines, ok_line, extra=None) -> GateResult:
    """A :class:`GateResult` whose last line is the OK line when no
    invariant failed."""
    if not failures:
        lines = lines + [f"OK: {ok_line}"]
    return GateResult(gate, runs, failures, lines, dict(extra or {}))


def run_gate(name: str, **kw) -> GateResult:
    """Run one gate by name and time it."""
    t0 = time.perf_counter()
    result = GATES[name](**kw)
    result.seconds = time.perf_counter() - t0
    return result


def report(result: GateResult) -> None:
    """Print a gate's lines, then each failure as ``FAIL:`` on stderr."""
    for line in result.lines:
        print(line)
    for failure in result.failures:
        print(f"FAIL: {failure}", file=sys.stderr)
    sys.stdout.flush()


def main(argv=None) -> int:
    """Run the chosen gates; returns 0 when every one passed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", choices=tuple(GATES), default=None,
                    help="run one gate (default: all of them)")
    ap.add_argument("--backend", choices=BACKENDS, default="torch_device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    names = [args.gate] if args.gate else list(GATES)
    failed = []
    with tempfile.TemporaryDirectory(prefix="smoke_torch_") as root:
        for name in names:
            print(f"== {name} ({args.backend}, {args.device}) ==")
            result = run_gate(name, backend=args.backend,
                              device=args.device, root=root)
            report(result)
            print(f"{name}: {result.seconds:.2f} s")
            if not result.ok:
                failed.append(name)
    if failed:
        print(f"FAIL: gates {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

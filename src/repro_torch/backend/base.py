"""Backend protocol and shared execution dataclasses.

An :class:`ExecutionBackend` turns a query's planning report (produced
by :class:`repro_torch.core.coordinator.CacheCoordinator`) into an
:class:`ExecutedQuery`. The planning layers never see the backend — the
same plans flow into either implementation, which is what makes the
byte-parity guarantees of ``tests/test_backend_parity.py`` hold by
construction.

:class:`DeviceBindingListener` is the hook surface a backend registers
on :class:`repro_torch.core.cache_state.CacheState` so committed device
buffers move or free in lockstep with cache residency (the same
life-cycle events the CoverageIndex syncs on: point-wise drop and
split-remap, plus a post-round reconcile after eviction/placement
reassign the resident set wholesale).
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

from repro_torch.obs.metrics import MetricsRegistry

if TYPE_CHECKING:  # planning types only; no runtime import cycle
    from repro_torch.core.cache_state import CacheState
    from repro_torch.core.chunk import ChunkMeta
    from repro_torch.core.coordinator import (CacheCoordinator, QueryReport,
                                        SimilarityJoinQuery)
    from repro_torch.faults.retry import DegradedResult

BACKENDS = ("simulated", "torch_device")


@dataclasses.dataclass
class ExecutedQuery:
    """A query's planning report plus its modeled phase times, the
    (really computed) join match count, and — when the backend performs
    real work — measured wall-clock/byte counters.

    The ``time_*_s`` fields are always the §4.1 *modeled* phase times so
    cross-backend comparisons stay apples-to-apples; ``measured_*``
    fields are ``None`` under the simulated backend and real measured
    quantities under the mesh backend.
    """

    report: "QueryReport"
    time_scan_s: float
    time_net_s: float
    time_compute_s: float
    time_opt_s: float
    matches: Optional[int]
    backend: str = "simulated"
    measured_net_s: Optional[float] = None      # wall-clock of transfers
    measured_compute_s: Optional[float] = None  # wall-clock of join kernels
    measured_ship_bytes: Optional[int] = None   # device bytes moved
    # Block-sparsity counters of the Pallas join path (None when the
    # numpy executor ran or no join executed): *_total is the dense
    # kernel's grid size over this query's chunk pairs, *_evaluated the
    # block pairs actually dispatched (equal under prune="dense").
    block_pairs_total: Optional[int] = None
    block_pairs_evaluated: Optional[int] = None
    # Pallas host-prep amortization observables (None off the pallas
    # path): prep_s is the host-side sort/prune/pad/stack wall-clock,
    # dispatch_s the kernel-dispatch wall-clock, and the artifact
    # counters are this query's hit/miss deltas against the
    # JoinArtifactCache (repro_torch.backend.artifacts) — a warm repeat query
    # over resident chunks shows hits > 0 and a collapsed prep_s.
    prep_s: Optional[float] = None
    dispatch_s: Optional[float] = None
    artifact_hits: Optional[int] = None
    artifact_misses: Optional[int] = None
    # Cell-exact bitmap-prune counters (None unless the bitmap stage ran
    # on at least one multi-block candidate this query — prune="bitmap",
    # or "auto" past its single-block fast path — so summaries of
    # workloads that never engage the feature are bit-identical to the
    # pre-bitmap ones): block pairs the hierarchical-bitmap intersection
    # proved dead after surviving the bbox prune, and the refinement
    # stage's wall-clock (also traced as a ``prep.bitmap`` span).
    block_pairs_bitmap_killed: Optional[int] = None
    bitmap_build_s: Optional[float] = None
    # Cross-batch multi-query-optimization counters (None when the
    # backend's ``mqo`` knob is off or the query was served from the
    # result cache): of this query's join tasks, how many there were
    # (*_total), how many it executed as the first subscriber of their
    # sharing signature (*_executed), and how many were served by a task
    # another query in the same admission batch already owned
    # (*_shared_hits). Per batch, sum(executed) == distinct tasks and
    # sum(shared_hits) == sum(total) - distinct tasks.
    mqo_tasks_total: Optional[int] = None
    mqo_tasks_executed: Optional[int] = None
    mqo_shared_hits: Optional[int] = None
    # Hot-chunk replication counters (None whenever the coordinator's
    # ``replication`` knob is off, so single-copy workload summaries are
    # bit-identical to the pre-replication ones): pair-sides this
    # query's join plan served in place from a secondary replica, and
    # secondaries the batch's replication round shed for budget
    # (attributed to the first query executed after the round).
    replica_hits: Optional[int] = None
    replicas_dropped: Optional[int] = None
    # Failure-recovery counters (None unless a ``fail_node`` event
    # occurred since the previous ExecutedQuery was built; attached to
    # the first query executed after the failure, whatever the
    # replication knob): chunks re-admitted, the bytes restored from
    # surviving replicas vs re-scanned from raw files, and the recovery
    # round's wall-clock.
    failover_readmits: Optional[int] = None
    recovery_bytes_from_replica: Optional[int] = None
    recovery_bytes_from_raw: Optional[int] = None
    recovery_s: Optional[float] = None
    # Transient-fault pipeline counters (None whenever the coordinator's
    # ``faults`` knob is off, so fault-free workload summaries are
    # bit-identical to the pre-fault ones): seeded injections attributed
    # to this query, retry activity (re-attempts, backoff seconds spent,
    # exhausted budgets), transfer re-routes to surviving replicas and
    # raw-file fallbacks, checksum mismatches caught on shipped
    # payloads, and whether this query degraded (0/1).
    faults_injected: Optional[int] = None
    retries: Optional[int] = None
    retry_backoff_s: Optional[float] = None
    retry_giveups: Optional[int] = None
    transfer_reroutes: Optional[int] = None
    raw_fallbacks: Optional[int] = None
    checksum_mismatch: Optional[int] = None
    degraded_queries: Optional[int] = None
    # Invariant-audit violations attributed to this query (None when no
    # auditor is armed; rides its own emission group so audit-only runs
    # don't drag the fault counters into summaries).
    audit_violations: Optional[int] = None
    # The typed degraded-mode payload (None = the query completed):
    # which sub-boxes were served / failed and which operations gave up.
    degraded: Optional["DegradedResult"] = None

    @property
    def time_total_s(self) -> float:
        """Modeled end-to-end latency: scan + net + compute + opt (§4.1)."""
        return (self.time_scan_s + self.time_net_s + self.time_compute_s
                + self.time_opt_s)


@runtime_checkable
class ExecutionBackend(Protocol):
    """How a planned query is carried out (simulated or for real)."""

    name: str

    def bind(self, coordinator: "CacheCoordinator") -> None:
        """Attach to a coordinator: the backend reads chunk coordinates
        and cache state through it (and, for device backends, registers
        its binding listener on ``coordinator.cache``)."""
        ...

    def execute(self, query: "SimilarityJoinQuery",
                report: "QueryReport") -> ExecutedQuery:
        """Execute one planned query; returns its ExecutedQuery."""
        ...

    def execute_batch(self, queries: Sequence["SimilarityJoinQuery"],
                      reports: Sequence["QueryReport"]
                      ) -> List[ExecutedQuery]:
        """Execute one admission batch's planned queries together. With
        the backend's ``mqo`` knob on, join tasks are deduplicated by
        sharing signature across the batch — each distinct task runs
        once and its match count fans out to every subscribing query;
        with ``mqo="off"`` this is exactly a per-query ``execute`` loop
        (``execute`` itself is a batch of one)."""
        ...


class DeviceBindingListener(Protocol):
    """Cache life-cycle hooks a residency-coupled component registers on
    ``CacheState.listeners`` — device buffers (``JaxMeshBackend``) and
    memoized join-prep artifacts (``JoinArtifactCache``) both move/free
    in lockstep with residency through this surface (mirror of the
    CoverageIndex sync points)."""

    def on_drop(self, chunk_id: int) -> None:
        """A chunk left the cache: free its committed buffer."""
        ...

    def on_split(self, parent_id: int, leaves: List["ChunkMeta"]) -> None:
        """A cached chunk split: retire the parent's buffer (children
        materialize at the next reconcile, at their inherited node)."""
        ...

    def reconcile(self, state: "CacheState") -> None:
        """Post-round sync: after eviction/placement reassign residency
        and locations wholesale, (re)materialize, move, or free buffers
        so every cached chunk's committed buffers match its replica set
        (``CacheState.replicas_of``)."""
        ...


# Summary counter names that only appear when their subsystem engaged
# (the registry's *emission groups*, reproducing the conditional keys of
# the legacy hand-rolled summary): counter name -> group. The leftover
# pending-event merge below uses the same map to surface post-workload
# events under the right group.
SUMMARY_GROUPS: Dict[str, str] = {
    "measured_net_s": "measured", "measured_compute_s": "measured",
    "measured_ship_bytes": "measured",
    "block_pairs_total": "block", "block_pairs_evaluated": "block",
    "prep_s": "prep", "dispatch_s": "prep",
    "artifact_hits": "prep", "artifact_misses": "prep",
    "block_pairs_bitmap_killed": "bitmap", "bitmap_build_s": "bitmap",
    "mqo_tasks_total": "mqo", "mqo_tasks_executed": "mqo",
    "mqo_shared_hits": "mqo",
    "replica_hits": "replica", "replicas_dropped": "replica",
    "failover_readmits": "failover",
    "recovery_bytes_from_replica": "failover",
    "recovery_bytes_from_raw": "failover", "recovery_s": "failover",
    "result_cache_hits": "result_cache",
    "faults_injected": "faults", "retries": "faults",
    "retry_backoff_s": "faults", "retry_giveups": "faults",
    "transfer_reroutes": "faults", "raw_fallbacks": "faults",
    "checksum_mismatch": "faults", "degraded_queries": "faults",
    "audit_violations": "audit",
}

# Ungrouped summary counters, in emission order (before any group).
_SUMMARY_BASE = (
    "total_time_s", "scan_time_s", "net_time_s", "compute_time_s",
    "opt_time_s", "bytes_scanned", "files_scanned", "queries",
    "reuse_hits", "reuse_bytes_served", "residual_bytes_scanned",
    "reuse_scan_skips",
)


def register_summary_counters(registry: MetricsRegistry) -> None:
    """Pre-register every workload-summary counter in emission order
    (idempotent — get-or-create), so ``as_summary`` key order matches
    the legacy summary regardless of which query records first."""
    for name in _SUMMARY_BASE:
        registry.counter(name)
    for name, group in SUMMARY_GROUPS.items():
        registry.counter(name, group=group)


def record_executed(registry: MetricsRegistry, e: ExecutedQuery) -> None:
    """Accumulate one ExecutedQuery into a registry's summary counters.

    Counters are named exactly as the ``workload_summary`` keys and
    accumulate in the same left-to-right order the legacy summary's
    ``sum()`` calls did, so registry totals equal summary values bit for
    bit. Optional subsystems accumulate unconditionally (``None`` -> 0)
    but their emission group is only marked present when the field is
    actually set — the registry equivalent of the legacy ``any(field is
    not None)`` guards."""
    register_summary_counters(registry)
    c = registry.counter
    c("total_time_s").inc(e.time_total_s)
    c("scan_time_s").inc(e.time_scan_s)
    c("net_time_s").inc(e.time_net_s)
    c("compute_time_s").inc(e.time_compute_s)
    c("opt_time_s").inc(e.time_opt_s)
    c("bytes_scanned").inc(sum(e.report.scan_bytes_by_node.values()))
    c("files_scanned").inc(len(e.report.files_scanned))
    c("queries").inc(1)
    c("reuse_hits").inc(e.report.reuse_hits)
    c("reuse_bytes_served").inc(e.report.reuse_bytes_served)
    c("residual_bytes_scanned").inc(e.report.residual_bytes_scanned)
    c("reuse_scan_skips").inc(e.report.reuse_scan_skips)
    c("measured_net_s").inc(e.measured_net_s or 0.0)
    c("measured_compute_s").inc(e.measured_compute_s or 0.0)
    c("measured_ship_bytes").inc(e.measured_ship_bytes or 0)
    c("block_pairs_total").inc(e.block_pairs_total or 0)
    c("block_pairs_evaluated").inc(e.block_pairs_evaluated or 0)
    c("prep_s").inc(e.prep_s or 0.0)
    c("dispatch_s").inc(e.dispatch_s or 0.0)
    c("artifact_hits").inc(e.artifact_hits or 0)
    c("artifact_misses").inc(e.artifact_misses or 0)
    c("block_pairs_bitmap_killed").inc(e.block_pairs_bitmap_killed or 0)
    c("bitmap_build_s").inc(e.bitmap_build_s or 0.0)
    c("mqo_tasks_total").inc(e.mqo_tasks_total or 0)
    c("mqo_tasks_executed").inc(e.mqo_tasks_executed or 0)
    c("mqo_shared_hits").inc(e.mqo_shared_hits or 0)
    c("replica_hits").inc(e.replica_hits or 0)
    c("replicas_dropped").inc(e.replicas_dropped or 0)
    c("failover_readmits").inc(e.failover_readmits or 0)
    c("recovery_bytes_from_replica").inc(e.recovery_bytes_from_replica or 0)
    c("recovery_bytes_from_raw").inc(e.recovery_bytes_from_raw or 0)
    c("recovery_s").inc(e.recovery_s or 0.0)
    c("faults_injected").inc(e.faults_injected or 0)
    c("retries").inc(e.retries or 0)
    c("retry_backoff_s").inc(e.retry_backoff_s or 0.0)
    c("retry_giveups").inc(e.retry_giveups or 0)
    c("transfer_reroutes").inc(e.transfer_reroutes or 0)
    c("raw_fallbacks").inc(e.raw_fallbacks or 0)
    c("checksum_mismatch").inc(e.checksum_mismatch or 0)
    c("degraded_queries").inc(e.degraded_queries or 0)
    c("audit_violations").inc(e.audit_violations or 0)
    hit = bool(getattr(e.report, "result_cache_hit", False))
    c("result_cache_hits").inc(1 if hit else 0)
    if e.measured_net_s is not None:
        registry.mark_group("measured")
    if e.block_pairs_total is not None:
        registry.mark_group("block")
    if e.prep_s is not None:
        registry.mark_group("prep")
    if e.block_pairs_bitmap_killed is not None:
        registry.mark_group("bitmap")
    if e.mqo_tasks_total is not None:
        registry.mark_group("mqo")
    if e.replica_hits is not None:
        registry.mark_group("replica")
    if e.failover_readmits is not None:
        registry.mark_group("failover")
    if e.faults_injected is not None:
        registry.mark_group("faults")
    if e.audit_violations is not None:
        registry.mark_group("audit")
    if hit:
        registry.mark_group("result_cache")


def workload_summary(executed: Sequence[ExecutedQuery],
                     coordinator: Optional["CacheCoordinator"] = None
                     ) -> Dict[str, float]:
    """Aggregate modeled times, scan volume, semantic-reuse counters, and
    (when present) measured backend quantities over an executed workload
    (the quantities the benchmarks report).

    Implemented on a fresh :class:`~repro_torch.obs.metrics.MetricsRegistry`
    via :func:`record_executed` — every counter keeps its legacy name,
    value, and emission condition. Pass ``coordinator=`` to also surface
    any replication/failover events still pending in its event channel
    (events posted after the last executed query would otherwise never
    drain into an ``ExecutedQuery``); the channel is asserted empty
    afterwards."""
    reg = MetricsRegistry()
    register_summary_counters(reg)
    for e in executed:
        record_executed(reg, e)
    if coordinator is not None:
        for key, v in coordinator.events.drain().items():
            group = SUMMARY_GROUPS.get(key)
            reg.counter(key, group=group).inc(v)
            if group is not None:
                reg.mark_group(group)
        assert coordinator.events.empty(), \
            "pending-event channel not empty after workload_summary"
    return reg.as_summary()

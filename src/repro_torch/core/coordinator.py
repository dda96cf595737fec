"""Cache coordinator: the Figure-2 planning pipeline, as thin layers.

For each similarity-join admission batch the coordinator runs:

  1. chunking refinement per query (Alg. 1) — ``ChunkManager``;
  2. join execution plan per query (chunk pair -> node, [63]-style);
  3. ONE cache eviction round over the batch (Alg. 2 / LRU / LFU) —
     ``EvictionPolicy`` from the registry;
  4. ONE cache placement round (Alg. 3 / static / origin) —
     ``PlacementPolicy`` from the registry, against ``CacheState``
     budgets (global pool or per-node hard limits via ``budget_scope``).

The coordinator sees only metadata (bounding boxes, counts, sizes, cache
content tables) — cell data stays on the nodes (the cluster layer).
``process_query`` is the single-query admission path (a batch of one);
``process_batch`` amortizes raw-file scans across the batch: a file
materialized for one query is not rescanned by a later query in the same
batch, and eviction/placement run once over the union touch set.

Policy combos (see ``repro_torch.core.policies``): ``cost``, ``chunk_lru``,
``file_lru`` reproduce the paper's three configurations; ``cost_static``,
``chunk_lfu``, ``file_lfu`` are registry-provided extensions.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Set, Tuple, Union)

if TYPE_CHECKING:  # duck-typed at runtime to avoid a package cycle
    from repro_torch.arrayio.catalog import Catalog, FileReader
    from repro_torch.faults import FaultInjector, RetryPolicy
from repro_torch.core.cache_state import CacheState
from repro_torch.core.chunk import ChunkMeta
from repro_torch.core.chunk_manager import ChunkManager
from repro_torch.core.coverage import QueryRewrite
from repro_torch.core.geometry import Box, points_in_box
from repro_torch.core.join_planner import JoinPlan, plan_join
from repro_torch.core.placement import JoinRecord, PlacementResult
from repro_torch.core.policies import (EvictionContext, PlacementContext, POLICIES,
                                 QueryAccess, REPLICATION_MODES,
                                 ReplicationContext, build_eviction,
                                 build_placement, build_replication,
                                 resolve_policy)
from repro_torch.core.result_cache import (RESULT_CACHE_MODES, ResultCache,
                                     ResultEntry)
from repro_torch.core.rtree import RefineStats
from repro_torch.faults.audit import InvariantAuditor
from repro_torch.faults.errors import (BatchInFlightError, RetryExhaustedError,
                                 ScanError)
from repro_torch.faults.injector import make_faults
from repro_torch.faults.retry import Retrier, make_retry
from repro_torch.obs.clock import Clock, as_clock
from repro_torch.obs.telemetry import EventChannel, Telemetry, make_telemetry

__all__ = ["AUDIT_MODES", "POLICIES", "REPLICATION_MODES", "REUSE_MODES",
           "RESULT_CACHE_MODES", "SimilarityJoinQuery", "QueryReport",
           "CacheCoordinator"]

# Invariant-auditor knob: "auto" (default) audits whenever fault
# injection is armed, "on" always audits, "off" never does.
AUDIT_MODES = ("auto", "on", "off")

# Semantic cache reuse knob: "off" preserves the seed pipeline exactly
# (every query goes through the catalog/scan path, whole chunks ship);
# "on" consults the CoverageIndex before a query's scan plan is built.
REUSE_MODES = ("off", "on")


@dataclasses.dataclass(frozen=True)
class SimilarityJoinQuery:
    """A similarity self-join over the cells inside ``box`` (§2.2): count
    unordered L1-neighbor pairs within radius ``eps``."""

    box: Box
    eps: int = 1


@dataclasses.dataclass
class QueryReport:
    """Per-query planning observables (the quantities Figures 5-8 plot,
    plus the semantic-reuse counters added by the CoverageIndex layer)."""

    query_index: int
    policy: str
    files_considered: int
    files_pruned: int
    files_scanned: List[int]
    scan_bytes_by_node: Dict[int, int]
    decode_cells_by_node: Dict[int, Dict[str, int]]
    queried_chunks: List[ChunkMeta]
    queried_cells: int
    join_plan: Optional[JoinPlan]
    placement: Optional[PlacementResult]
    placement_extra_bytes: int
    cached_bytes_after: int
    cached_chunks_after: int
    evicted_items: int
    opt_time_chunking_s: float
    opt_time_evict_place_s: float
    refine_stats: RefineStats
    batch_size: int = 1
    # Semantic-reuse observables (all zero when the reuse knob is "off").
    reuse_hits: int = 0                 # cached chunks served by slicing
    reuse_bytes_served: int = 0         # sliced extent bytes from cache
    residual_bytes_scanned: int = 0     # raw bytes the residual path scanned
    reuse_scan_skips: int = 0           # file scans avoided by containment
    reuse_fully_covered: bool = False   # box-level residual was empty
    # Result-cache observables: a hit report is planning-free — the
    # coordinator served the stored match count (``cached_matches``)
    # before chunking/join-planning/policy rounds ran for this query.
    result_cache_hit: bool = False
    cached_matches: Optional[int] = None
    # Degraded-mode observables (both empty unless a retry budget was
    # exhausted during planning — see ``repro_torch.faults``): sub-boxes of
    # the query that could not be served, and the operations that gave
    # up on them. The backend folds execution-time failures in and
    # surfaces the union as ``ExecutedQuery.degraded``.
    degraded_boxes: Tuple[Box, ...] = ()
    failed_ops: Tuple[str, ...] = ()


@dataclasses.dataclass
class _QueryPlan:
    """Per-query planning output, pending the batch eviction/placement."""

    query: SimilarityJoinQuery
    query_index: int
    files_considered: int
    files_pruned: int
    files_scanned: List[int]
    scan_bytes_by_node: Dict[int, int]
    decode_cells_by_node: Dict[int, Dict[str, int]]
    queried: List[ChunkMeta]
    queried_cells: int
    join_plan: JoinPlan
    opt_time_chunking_s: float
    refine_stats: RefineStats
    online_evicted: int = 0
    rewrite: Optional[QueryRewrite] = None
    reuse_hits: int = 0
    reuse_bytes_served: int = 0
    reuse_scan_skips: int = 0
    degraded_boxes: List[Box] = dataclasses.field(default_factory=list)
    failed_ops: List[str] = dataclasses.field(default_factory=list)


class CacheCoordinator:
    """The Figure-2 planning pipeline as a thin conductor over the layers.

    ``process_query`` admits a batch of one; ``process_batch`` shares
    raw-file scans across a batch and runs one eviction/placement round.
    ``reuse="on"`` enables the semantic cache-reuse rewrite: before a
    query's scan plan is built the coordinator consults the
    ``CacheState.coverage`` index, serves covered sub-regions from
    resident chunks sliced in place (shipping only the sliced extent), and
    sends only the residual region down the catalog/scan path — a file
    scan is skipped when every actually-queried cell of that file lives in
    a covering cached chunk (box-level prune + cell-exact containment
    test). ``reuse="off"`` (default) preserves seed-exact behavior.
    Cumulative reuse counters live in :attr:`stats`.
    """

    # Per-round multiplicative decay of the replication policy's access
    # frequencies (steady-state frequency of a chunk touched every query
    # is 1/(1-decay) = 5.0 — the default promotion threshold of 3.0 sits
    # comfortably below it).
    REPLICA_FREQ_DECAY = 0.8

    def __init__(self, catalog: "Catalog", reader: "FileReader", n_nodes: int,
                 node_budget_bytes: int, policy: str = "cost",
                 placement_mode: str = "dynamic", min_cells: int = 256,
                 decay: float = 2.0, history_window: int = 64,
                 budget_scope: str = "global", reuse: str = "off",
                 result_cache: str = "off",
                 result_cache_capacity: int = 256,
                 result_cache_ttl_s: Optional[float] = None,
                 replication: str = "off", replica_k: int = 2,
                 replication_threshold: float = 3.0,
                 telemetry: Union[str, Telemetry, None] = None,
                 clock: Union[Clock, Callable[[], float], None] = None,
                 faults: "Union[str, FaultInjector, Dict[str, float], None]"
                 = "off",
                 retry: "Union[str, RetryPolicy, Dict[str, float], None]"
                 = None,
                 audit: str = "auto"):
        if reuse not in REUSE_MODES:
            raise ValueError(f"unknown reuse mode {reuse!r}; "
                             f"expected one of {REUSE_MODES}")
        if result_cache not in RESULT_CACHE_MODES:
            raise ValueError(
                f"unknown result_cache mode {result_cache!r}; "
                f"expected one of {RESULT_CACHE_MODES}")
        if replication not in REPLICATION_MODES:
            raise ValueError(f"unknown replication mode {replication!r}; "
                             f"expected one of {REPLICATION_MODES}")
        self.spec = resolve_policy(policy, placement_mode)
        self.catalog = catalog
        self.reader = reader
        self.n_nodes = n_nodes
        self.policy = policy
        self.placement_mode = placement_mode
        self.decay = decay
        self.history_window = history_window
        self.reuse = reuse
        # Telemetry bundle (off = shared no-op tracer/registry, seed
        # parity) and the ONE clock every planning-side timing reads —
        # override ``clock`` to make phase timings deterministic.
        self.telemetry = make_telemetry(telemetry)
        self.clock = (as_clock(clock) if clock is not None
                      else self.telemetry.clock)
        # Transient-fault pipeline (see ``repro_torch.faults``): the seeded
        # injector behind the ``fault_point`` seam (None = seam never
        # consulted, seed-exact), the shared retrier both the planner
        # and the execution backend route transient failures through,
        # and the cross-layer invariant auditor ("auto" = armed with
        # faults). All off by default.
        if audit not in AUDIT_MODES:
            raise ValueError(f"unknown audit mode {audit!r}; "
                             f"expected one of {AUDIT_MODES}")
        self.faults = make_faults(faults, clock=self.clock)
        self.retry_policy = make_retry(retry)
        self.retrier = (Retrier(self.retry_policy, clock=self.clock,
                                tracer=self.telemetry.tracer)
                        if self.faults is not None else None)
        self.auditor: Optional[InvariantAuditor] = None
        if audit == "on" or (audit == "auto" and self.faults is not None):
            self.auditor = InvariantAuditor(self)
        # fail_node guard rails: reject crash-restarts mid-batch and
        # double-failing a node before any admission round re-ran.
        self._in_batch = False
        self._last_failed: Optional[int] = None

        self.chunks = ChunkManager(catalog, reader, min_cells,
                                   node_budget_bytes, clock=self.clock)
        self.cache = CacheState(n_nodes, node_budget_bytes, budget_scope)
        self.eviction = build_eviction(self.spec, self.cache.total_budget,
                                       decay, history_window)
        self.placement = build_placement(self.spec)
        # Hot-chunk replication round (a no-op object under "off" — the
        # pipeline stays bit-for-bit the single-copy path: the round,
        # frequency tracking, and per-query counters are all skipped).
        self.replication = replication
        self.replicator = build_replication(replication, k=replica_k,
                                            threshold=replication_threshold)
        # Decayed per-chunk access frequency (the replication policy's
        # workload stats): +1 per query touch, x REPLICA_FREQ_DECAY per
        # policy round. Maintained only when replication is on.
        self.access_freq: Dict[int, float] = {}
        # Counters the execution backend attaches to the next
        # ExecutedQuery it builds (drained once — see
        # :meth:`drain_exec_counters`); ``workload_summary`` surfaces
        # anything still pending after the last query, so post-workload
        # events are never silently lost.
        self.events = EventChannel(self.telemetry.registry)
        self.join_history: List[JoinRecord] = []   # Alg. 3 workload W
        self.query_counter = 0
        # Queries that went through the planning pipeline (a result-cache
        # hit does NOT increment this — the counter is the observable
        # proving repeats bypass chunking/planning/policy rounds).
        self.planner_invocations = 0
        # The versioned result tier (None when the knob is off); rides
        # the same CacheState listener surface as device buffers and
        # join artifacts so residency churn invalidates stored results.
        self.result_cache: Optional[ResultCache] = None
        if result_cache == "on":
            self.result_cache = ResultCache(capacity=result_cache_capacity,
                                            ttl_s=result_cache_ttl_s,
                                            clock=self.clock)
            self.cache.add_listener(self.result_cache)
        if self.auditor is not None:
            # Listener registration is observational only (the auditor's
            # hooks never mutate); the actual invariant passes run via
            # explicit ``auditor.audit()`` calls after sync points.
            self.cache.add_listener(self.auditor)
        # Cumulative semantic-reuse counters (bench_caching surfaces them).
        self.stats: Dict[str, float] = {
            "reuse_hits": 0, "reuse_bytes_served": 0,
            "residual_bytes_scanned": 0, "reuse_scan_skips": 0,
            "reuse_fully_covered_queries": 0,
            "result_cache_hits": 0, "result_cache_misses": 0,
            # Replication/failover counters (stay 0 when the replication
            # knob is off and no node ever fails).
            "replica_hits": 0, "replicas_dropped": 0,
            "node_failures": 0, "failover_readmits": 0,
            "recovery_bytes_from_replica": 0, "recovery_bytes_from_raw": 0,
            "recovery_s": 0.0,
        }
        # Resident-set snapshot the cache-health instrumentation diffs
        # against (residency churn per policy round; telemetry-on only).
        self._prev_resident: Set[int] = set()

    # ------------------------------------------------- legacy-shaped views

    @property
    def trees(self):
        """Per-file evolving R-trees (seed-API view of ChunkManager)."""
        return self.chunks.trees

    @property
    def chunk_file(self) -> Dict[int, int]:
        """chunk id -> owning file id (seed-API view of ChunkManager)."""
        return self.chunks.chunk_file

    @property
    def cached(self) -> Set[int]:
        """Resident chunk-id set (seed-API view of CacheState)."""
        return self.cache.cached

    @property
    def locations(self) -> Dict[int, int]:
        """Cached chunk -> PRIMARY node snapshot (seed-API view of
        CacheState; the full replica tuples live behind
        ``cache.replicas_of``)."""
        return self.cache.primary_map()

    @property
    def node_budget(self) -> int:
        """Per-node cache budget in bytes (seed-API view of CacheState)."""
        return self.cache.node_budget

    @property
    def total_budget(self) -> int:
        """Aggregate cache budget in bytes (seed-API view of CacheState)."""
        return self.cache.total_budget

    @property
    def min_cells(self) -> int:
        """Alg. 1 minimum chunk population (seed-API view)."""
        return self.chunks.min_cells

    # ------------------------------------------------------------- queries

    def process_query(self, query: SimilarityJoinQuery) -> QueryReport:
        """Admit one query (a batch of one): the paper's per-query
        admission path, including the semantic-reuse rewrite when the
        ``reuse`` knob is on."""
        return self.process_batch([query])[0]

    def process_batch(self, queries: Sequence[SimilarityJoinQuery]
                      ) -> List[QueryReport]:
        """Admit a batch: per-query chunking + join planning with raw-file
        scans shared across the batch, then a single eviction/placement
        round over the union touch set.

        With the ``result_cache`` knob on, every query is first probed
        against the versioned result tier — a hit yields a planning-free
        hit report (``result_cache_hit=True``) and the query skips
        chunking, join planning, and the policy round entirely; a batch
        of pure hits runs no policy round at all."""
        if not queries:
            return []
        queries = list(queries)
        hit_reports: Dict[int, QueryReport] = {}
        to_plan: List[SimilarityJoinQuery] = []
        plan_pos: List[int] = []           # position in the batch
        for i, q in enumerate(queries):
            entry = (self.result_cache.lookup(
                ResultCache.key_of(q.box, q.eps))
                if self.result_cache is not None else None)
            if entry is not None:
                self.query_counter += 1
                self.stats["result_cache_hits"] += 1
                hit_reports[i] = self._result_cache_report(
                    q, entry, len(queries))
            else:
                if self.result_cache is not None:
                    self.stats["result_cache_misses"] += 1
                to_plan.append(q)
                plan_pos.append(i)
        if not to_plan:                    # pure-hit batch: planner untouched
            return [hit_reports[i] for i in range(len(queries))]
        # Planning + policy rounds mutate residency wholesale; a
        # crash-restart interleaved here would corrupt accounting, so
        # fail_node is rejected while the flag is up (typed error).
        self._in_batch = True
        try:
            plans: List[_QueryPlan] = []
            batch_scanned: Set[int] = set()    # files materialized this batch
            for q in to_plan:
                self.query_counter += 1
                self.planner_invocations += 1
                if self.spec.granularity == "file":
                    plans.append(self._plan_file_query(q, self.query_counter))
                else:
                    plans.append(self._plan_chunked_query(
                        q, self.query_counter, batch_scanned))

            tracer = self.telemetry.tracer
            t0 = self.clock.now()
            chunk_bytes, file_bytes = self.chunks.size_tables()
            # An early query's chunk may have been split by a later query in
            # the same batch: remap every access onto the present leaf set
            # (identity for a batch of one) before the policy rounds.
            accesses: List[QueryAccess] = []
            for p in plans:
                queried_now: List[ChunkMeta] = []
                by_file_now: Dict[int, List[int]] = {}
                for cm in p.queried:
                    for u in self.chunks.current_units(cm):
                        queried_now.append(u)
                        by_file_now.setdefault(u.file_id, []).append(u.chunk_id)
                accesses.append(QueryAccess(p.query_index, queried_now,
                                            by_file_now))
            deferred_evicted = 0
            if self.spec.granularity == "chunk":
                # File units admit online during the scan loop; chunk units
                # admit here, in one Alg.-2/LRU/LFU round over the batch.
                with tracer.span("policy.evict", queries=len(plans)):
                    deferred_evicted = self.eviction.finalize_batch(
                        EvictionContext(
                            accesses=accesses, chunk_bytes=chunk_bytes,
                            file_bytes=file_bytes, state=self.cache,
                            chunks=self.chunks))

            replicas: Dict[int, Set[int]] = {}
            for p in plans:
                for cid, nodes in p.join_plan.replicas.items():
                    replicas.setdefault(cid, set()).update(nodes)
            with tracer.span("policy.place", queries=len(plans)):
                placement, extra_bytes = self.placement.place(PlacementContext(
                    replicas=replicas,
                    queried=[cm for acc in accesses for cm in acc.queried],
                    join_history=self.join_history, chunk_bytes=chunk_bytes,
                    node_budgets=self.cache.placement_budgets(),
                    state=self.cache, home_of=self.chunks.home_node,
                    decay=self.decay, history_window=self.history_window))
            if placement is not None:
                # Keep the eviction policy's residency view in sync with
                # placement drops (no-op for cost: triples re-enter as
                # uncached bytes next round, the seed behavior).
                for cid in placement.dropped:
                    self.eviction.discard(cid)
            if self.replication != "off":
                # Replication round: update the decayed access frequencies
                # from this batch's (remapped) touch set, then let the policy
                # re-apply/promote secondaries into whatever budget the
                # eviction/placement rounds left free. Runs strictly after
                # them so residency and primaries are already final — which
                # is what makes secondaries cheaper to drop than sole copies.
                with tracer.span("policy.replicate", queries=len(plans)):
                    for cid in list(self.access_freq):
                        self.access_freq[cid] *= self.REPLICA_FREQ_DECAY
                        if self.access_freq[cid] < 1e-3:
                            del self.access_freq[cid]
                    for acc in accesses:
                        for cm in acc.queried:
                            self.access_freq[cm.chunk_id] = \
                                self.access_freq.get(cm.chunk_id, 0.0) + 1.0
                    shed = self.replicator.replicate(ReplicationContext(
                        state=self.cache, chunk_bytes=chunk_bytes,
                        freq=self.access_freq, home_of=self.chunks.home_node))
                self.stats["replicas_dropped"] += shed
                self.events.post("replicas_dropped", shed)
                for p in plans:
                    self.stats["replica_hits"] += p.join_plan.replica_hits
            t_evict_place = self.clock.now() - t0

            # Policy rounds reassign the resident set wholesale; reconcile any
            # device-backed buffer bindings (no-op without a device backend).
            self.cache.sync_devices()

            if self.reuse == "on":
                # Policy rounds reassign the resident set wholesale; reconcile
                # the coverage index so the next batch's rewrite sees it.
                self.cache.sync_coverage(self.chunks.meta_of)
                for p in plans:
                    self.stats["reuse_hits"] += p.reuse_hits
                    self.stats["reuse_bytes_served"] += p.reuse_bytes_served
                    self.stats["residual_bytes_scanned"] += \
                        sum(p.scan_bytes_by_node.values())
                    self.stats["reuse_scan_skips"] += p.reuse_scan_skips
                    if p.rewrite is not None and p.rewrite.fully_covered:
                        self.stats["reuse_fully_covered_queries"] += 1

            if self.auditor is not None:
                # Cross-check the listener-coupled tiers right after every
                # policy round's sync points (see repro_torch.faults.audit).
                self.auditor.audit()
            # A completed admission round re-populates the cluster; the
            # double-fail guard resets so the next crash can target any node.
            self._last_failed = None

            if self.telemetry.enabled:
                self._record_cache_health(chunk_bytes)

            cached_bytes = self.cache.cached_bytes(chunk_bytes)
            cached_chunks = len(self.cache.cached)
            out: List[Optional[QueryReport]] = [
                hit_reports.get(i) for i in range(len(queries))]
            for i, p in enumerate(plans):
                last = i == len(plans) - 1
                out[plan_pos[i]] = (QueryReport(
                    query_index=p.query_index, policy=self.policy,
                    files_considered=p.files_considered,
                    files_pruned=p.files_pruned,
                    files_scanned=p.files_scanned,
                    scan_bytes_by_node=p.scan_bytes_by_node,
                    decode_cells_by_node=p.decode_cells_by_node,
                    queried_chunks=p.queried, queried_cells=p.queried_cells,
                    join_plan=p.join_plan,
                    placement=placement if last else None,
                    placement_extra_bytes=extra_bytes if last else 0,
                    cached_bytes_after=cached_bytes,
                    cached_chunks_after=cached_chunks,
                    evicted_items=p.online_evicted
                    + (deferred_evicted if last else 0),
                    opt_time_chunking_s=p.opt_time_chunking_s,
                    opt_time_evict_place_s=t_evict_place if last else 0.0,
                    refine_stats=p.refine_stats, batch_size=len(plans),
                    reuse_hits=p.reuse_hits,
                    reuse_bytes_served=p.reuse_bytes_served,
                    residual_bytes_scanned=(
                        sum(p.scan_bytes_by_node.values())
                        if self.reuse == "on" else 0),
                    reuse_scan_skips=p.reuse_scan_skips,
                    reuse_fully_covered=(p.rewrite is not None
                                         and p.rewrite.fully_covered),
                    degraded_boxes=tuple(p.degraded_boxes),
                    failed_ops=tuple(p.failed_ops)))
            return out
        finally:
            self._in_batch = False

    # -------------------------------------------- cache-health telemetry

    def _record_cache_health(self, chunk_bytes: Dict[int, int]) -> None:
        """Refresh the registry's cache-health instruments after a policy
        round (telemetry-on only): per-node budget utilization gauges,
        the replica-skew gauge (max/mean of cached bytes per node; 1.0 =
        perfectly balanced, 0 = empty cache), a residency-churn histogram
        (symmetric difference of the resident set vs the previous
        round), and ``coord.*`` gauge mirrors of :attr:`stats`."""
        reg = self.telemetry.registry
        used = self.cache.bytes_by_node(chunk_bytes)
        budget = max(self.cache.node_budget, 1)
        vals = [used.get(n, 0) for n in range(self.n_nodes)]
        for node, b in enumerate(vals):
            reg.gauge("cache.budget_utilization", node=node).set(b / budget)
        mean = sum(vals) / max(len(vals), 1)
        reg.gauge("cache.replica_skew").set(max(vals) / mean if mean > 0
                                            else 0.0)
        resident = set(self.cache.cached)
        reg.histogram("cache.residency_churn").observe(
            len(resident ^ self._prev_resident))
        self._prev_resident = resident
        for k, v in self.stats.items():
            reg.gauge(f"coord.{k}").set(v)

    # ------------------------------------------------ result-cache tier

    def _result_cache_report(self, query: SimilarityJoinQuery,
                             entry: ResultEntry,
                             batch_size: int) -> QueryReport:
        """The planning-free report of a result-cache hit: no files
        considered/scanned, no join plan, zero optimization time — the
        served observables (match count, queried cells, cache occupancy)
        come from the stored entry, which the version stamp guarantees
        was computed under the current residency."""
        return QueryReport(
            query_index=self.query_counter, policy=self.policy,
            files_considered=0, files_pruned=0, files_scanned=[],
            scan_bytes_by_node={}, decode_cells_by_node={},
            queried_chunks=[], queried_cells=entry.queried_cells,
            join_plan=None, placement=None, placement_extra_bytes=0,
            cached_bytes_after=entry.cached_bytes_after,
            cached_chunks_after=entry.cached_chunks_after,
            evicted_items=0, opt_time_chunking_s=0.0,
            opt_time_evict_place_s=0.0, refine_stats=RefineStats(),
            batch_size=batch_size, result_cache_hit=True,
            cached_matches=entry.matches)

    def record_result(self, query: SimilarityJoinQuery,
                      executed) -> None:
        """Write-back after execution: store a planned query's computed
        match count (plus the observables a future hit will serve) under
        the current residency version. No-op when the tier is off, the
        query was itself a hit, the backend computed no matches
        (``execute_joins=False``), or the query degraded — a partial
        match count must never be served to a future exact repeat."""
        if self.result_cache is None:
            return
        report = executed.report
        if report.result_cache_hit or executed.matches is None:
            return
        if getattr(executed, "degraded", None) is not None:
            return
        self.result_cache.store(
            ResultCache.key_of(query.box, query.eps),
            executed.matches, queried_cells=report.queried_cells,
            cached_bytes_after=report.cached_bytes_after,
            cached_chunks_after=report.cached_chunks_after)

    # ------------------------------------------ simulated failure handling

    def drain_exec_counters(self) -> Dict[str, float]:
        """Hand the pending replication/failover counters to the
        execution backend (drained once — the first ``ExecutedQuery``
        built after the event carries them; see
        ``repro_torch.backend.base.ExecutedQuery``). Events posted after the
        last query stay in :attr:`events` until ``workload_summary``
        surfaces them."""
        return self.events.drain()

    def _fits_at(self, node: int, nbytes: int,
                 chunk_bytes: Dict[int, int]) -> bool:
        """Whether one more copy of ``nbytes`` fits at ``node`` under the
        budget scope (per-node hard limit or unified pool), charging
        every currently-held replica."""
        if nbytes <= 0:
            return True
        used = self.cache.bytes_by_node(chunk_bytes)
        if self.cache.budget_scope == "node":
            return used.get(node, 0) + nbytes <= self.cache.node_budget
        return sum(used.values()) + nbytes <= self.cache.total_budget

    def fail_node(self, node: int) -> Dict[str, float]:
        """Simulate a crash-restart of one node: every cached copy it
        held is lost (raw files are durable; the node rejoins empty) and
        the coordinator immediately re-admits what it can —

          * a chunk with surviving replicas shrinks to the survivors,
            then the lost copy is restored onto the restarted node from
            a survivor when budget allows (cheap — charged to
            ``recovery_bytes_from_replica``);
          * a sole-copy chunk is dropped through ``CacheState.drop`` (so
            the device-buffer, join-artifact, and result-cache listeners
            all forget it point-wise) and re-admitted from its raw file
            at its home node when budget allows (charged to
            ``recovery_bytes_from_raw``).

        The round ends with ``sync_devices`` (and, under semantic
        reuse, ``sync_coverage``), so
        every listener-driven tier reconciles against the post-failure
        residency (the result tier's snapshot diff bumps its version on
        any replica-set change — no stored result computed against a
        dead replica is ever served). Returns this event's counters;
        they also accumulate in :attr:`stats` and ride the next
        ``ExecutedQuery`` via :meth:`drain_exec_counters`.

        Guard rails: a non-integral or out-of-range ``node`` raises
        ``ValueError`` before any accounting is touched; so does failing
        the same node twice with no admission batch in between (the
        node is still empty — a second "crash" would double-count
        recovery). Calling this mid-``process_batch`` raises the typed
        :class:`~repro_torch.faults.errors.BatchInFlightError`."""
        try:
            node = operator.index(node)
        except TypeError:
            raise ValueError(
                f"node must be an integer, got {node!r}") from None
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"node {node} outside 0..{self.n_nodes - 1}")
        if self._in_batch:
            raise BatchInFlightError(
                f"fail_node({node}) called while an admission batch is in "
                f"flight; crash-restarts are only valid between batches")
        if node == self._last_failed:
            raise ValueError(
                f"node {node} already failed with no admission batch since; "
                f"it is still empty — failing it again would corrupt "
                f"recovery accounting")
        recover_span = self.telemetry.tracer.begin("recover", node=node)
        t0 = self.clock.now()
        chunk_bytes, _ = self.chunks.size_tables()
        readmits = 0
        from_replica = 0
        from_raw = 0
        for cid, reps in self.cache.location_items():
            if cid not in self.cache.cached or node not in reps:
                continue
            survivors = tuple(n for n in reps if n != node)
            nbytes = chunk_bytes.get(cid, 0)
            if survivors:
                self.cache.set_replicas(cid, survivors)
                if (self._fits_at(node, nbytes, chunk_bytes)
                        and self._readmit_ok(cid, node)):
                    self.cache.set_replicas(cid, survivors + (node,))
                    from_replica += nbytes
                    readmits += 1
            else:
                self.cache.drop(cid)
                home = (self.chunks.home_node(cid)
                        if self.chunks.meta_of(cid) is not None else None)
                if (home is not None
                        and self._fits_at(home, nbytes, chunk_bytes)
                        and self._readmit_ok(cid, home)):
                    self.cache.cached.add(cid)
                    self.cache.set_replicas(cid, (home,))
                    from_raw += nbytes
                    readmits += 1
                else:
                    # Not recoverable right now (no budget, or the
                    # readmit itself retried out): release any eviction-
                    # policy bookkeeping so the id cannot resurrect into
                    # residency without a fresh scan.
                    self.eviction.discard(cid)
        # The coverage index is kept only under semantic reuse, as the
        # policy rounds keep it: populating it here with reuse off would
        # leave entries that no later round removes when their chunks
        # are evicted.
        if self.reuse == "on":
            self.cache.sync_coverage(self.chunks.meta_of)
        self.cache.sync_devices()
        event = {
            "failover_readmits": float(readmits),
            "recovery_bytes_from_replica": float(from_replica),
            "recovery_bytes_from_raw": float(from_raw),
            "recovery_s": self.clock.now() - t0,
        }
        self.telemetry.tracer.end(recover_span)
        self.stats["node_failures"] += 1
        self._last_failed = node
        if self.auditor is not None:
            self.auditor.audit()
        for k, v in event.items():
            self.stats[k] += v
            self.events.post(k, v)
        return event

    def _readmit_ok(self, cid: int, node: int) -> bool:
        """One guarded ``recover.readmit`` crossing for re-admitting lost
        chunk ``cid`` onto ``node`` during crash recovery. True (always,
        when faults are off) means proceed; False means the readmit
        retried out and the chunk stays unrecovered this round."""
        if self.faults is None:
            return True
        try:
            self.retrier.call(
                "recover.readmit",
                lambda a: self.faults.fault_point(
                    "recover.readmit", chunk=cid, node=node, attempt=a))
            return True
        except RetryExhaustedError:
            return False

    # ---- per-query planning: chunk granularity (cost, chunk_lru, ...) ----

    def _plan_chunked_query(self, query: SimilarityJoinQuery, l: int,
                            batch_scanned: Set[int]) -> _QueryPlan:
        """Plan one chunk-granularity query: semantic-reuse rewrite (when
        enabled), Alg.-1 refinement, scan accounting, and join planning."""
        reuse_on = self.reuse == "on"
        tracer = self.telemetry.tracer
        # Semantic rewrite, BEFORE the scan plan is built: covered slices
        # (cached chunks overlapping the query, sliced to it) plus the
        # residual region left after subtracting their boxes.
        rewrite: Optional[QueryRewrite] = None
        if reuse_on:
            with tracer.span("query.rewrite", query=l):
                rewrite = self.cache.coverage.rewrite(query.box)
        candidates = self.catalog.files_overlapping(query.box)
        scans: List[int] = []
        scan_bytes: Dict[int, int] = {}
        decode_cells: Dict[int, Dict[str, int]] = {}
        queried: List[ChunkMeta] = []
        ship_bytes: Dict[int, int] = {}
        cells_in_q = 0
        pruned = 0
        reuse_hits = 0
        reuse_bytes = 0
        scan_skips = 0
        degraded: List[Box] = []
        failed_ops: List[str] = []
        t0 = self.clock.now()
        rstats = RefineStats()
        scan_span = tracer.begin("plan.scan", query=l,
                                 files=len(candidates))
        for meta in candidates:
            first_touch = meta.file_id not in self.chunks.trees
            try:
                tree = self._guarded_scan(
                    meta, query,
                    arm=lambda m=meta: m.file_id not in self.chunks.trees,
                    fn=lambda m=meta: self.chunks.tree(m))
            except RetryExhaustedError as e:
                self._degrade_file(meta, query, degraded, failed_ops, e.op)
                continue
            overlapping = tree.overlapping(query.box)
            if not overlapping:
                pruned += 1           # refined boxes prune the file entirely
                continue
            stale = [c for c in overlapping
                     if c.chunk_id not in self.cache.cached]
            needs_scan = first_touch or bool(stale)
            if reuse_on and stale and not first_touch:
                # Box overlap alone does not force a rescan: leaf boxes are
                # tight, so the file's queried cells are exactly those of
                # its leaves inside the query. If every stale (uncached)
                # leaf holds no queried cell, the query region of this file
                # is covered by cached chunks (plus provably-empty space)
                # and the scan is skipped — the cell-exact containment
                # test behind the CoverageIndex's box-level rewrite.
                needs_scan = any(
                    points_in_box(tree.coords[c.cell_idx], query.box).any()
                    for c in stale)
                if not needs_scan:
                    scan_skips += 1
            miss = needs_scan and meta.file_id not in batch_scanned
            if miss and not first_touch and self.faults is not None:
                # Stale chunks force a rescan of an already-built file:
                # a distinct scan.read crossing (the first-touch read was
                # armed inside _guarded_scan above).
                try:
                    self.retrier.call(
                        "scan.read",
                        lambda a, m=meta: self.faults.fault_point(
                            "scan.read", file=m.file_id, attempt=a))
                except RetryExhaustedError as e:
                    self._degrade_file(meta, query, degraded, failed_ops,
                                       e.op)
                    continue
            chunks = tree.refine(query.box, rstats)
            self.chunks.remap_after_splits(tree, self.cache, self.eviction)
            if miss:
                scans.append(meta.file_id)
                batch_scanned.add(meta.file_id)
                scan_bytes[meta.node] = (scan_bytes.get(meta.node, 0)
                                         + meta.file_bytes)
                decode_cells.setdefault(meta.node, {}).setdefault(meta.fmt, 0)
                decode_cells[meta.node][meta.fmt] += meta.n_cells
            if not chunks:
                # Overlap was empty space — carved off by the refinement.
                continue
            for c in chunks:
                cm = ChunkMeta.of(c)
                queried.append(cm)
                n_in_q = int(points_in_box(
                    tree.coords[c.cell_idx], query.box).sum())
                cells_in_q += n_in_q
                if reuse_on and cm.chunk_id in self.cache.coverage:
                    # Covering cached chunk (the CoverageIndex is the
                    # slice-serving source of truth; split remaps keep it
                    # live mid-query): its owner slices the queried extent
                    # in place and the join ships only the slice.
                    sliced = n_in_q * (cm.nbytes // max(cm.n_cells, 1))
                    ship_bytes[cm.chunk_id] = sliced
                    if sliced > 0:
                        reuse_hits += 1
                        reuse_bytes += sliced
        tracer.end(scan_span)
        t_chunking = self.clock.now() - t0

        # Locations at query start: the cached replica set (a one-tuple
        # in the single-copy default), else the home node (the scan just
        # materialized the chunk there).
        locations = {cm.chunk_id: (self.cache.replicas_of(cm.chunk_id)
                                   or self.catalog.by_id(cm.file_id).node)
                     for cm in queried}
        jplan = plan_join(queried, locations,
                          0 if query.eps <= 0 else query.eps, self.n_nodes,
                          ship_bytes=ship_bytes or None)
        self.join_history.append(JoinRecord(l, tuple(jplan.pairs)))
        if len(self.join_history) > self.history_window:
            self.join_history = self.join_history[-self.history_window:]

        return _QueryPlan(
            query=query, query_index=l, files_considered=len(candidates),
            files_pruned=pruned, files_scanned=scans,
            scan_bytes_by_node=scan_bytes, decode_cells_by_node=decode_cells,
            queried=queried, queried_cells=cells_in_q, join_plan=jplan,
            opt_time_chunking_s=t_chunking, refine_stats=rstats,
            rewrite=rewrite, reuse_hits=reuse_hits,
            reuse_bytes_served=reuse_bytes, reuse_scan_skips=scan_skips,
            degraded_boxes=degraded, failed_ops=failed_ops)

    # ---- per-query planning: file granularity (file_lru, file_lfu) ----

    def _plan_file_query(self, query: SimilarityJoinQuery,
                         l: int) -> _QueryPlan:
        """Whole files as single-chunk units, admitted online: the scan
        decision consults the live cache, so an admission earlier in the
        loop can evict (and force a rescan of) a later candidate — the
        paper's file-LRU baseline semantics.

        With ``reuse="on"``, resident file units covering part of the query
        are sliced in place for the join (shipping only the sliced extent);
        scans are never skipped here — whole-file units carry no finer
        extent metadata to run the containment test against."""
        reuse_on = self.reuse == "on"
        tracer = self.telemetry.tracer
        rewrite: Optional[QueryRewrite] = None
        if reuse_on:
            with tracer.span("query.rewrite", query=l):
                rewrite = self.cache.coverage.rewrite(query.box)
        candidates = self.catalog.files_overlapping(query.box)
        scans: List[int] = []
        scan_bytes: Dict[int, int] = {}
        decode_cells: Dict[int, Dict[str, int]] = {}
        queried: List[ChunkMeta] = []
        ship_bytes: Dict[int, int] = {}
        cells_in_q = 0
        evicted = 0
        reuse_hits = 0
        reuse_bytes = 0
        degraded: List[Box] = []
        failed_ops: List[str] = []
        scan_span = tracer.begin("plan.scan", query=l,
                                 files=len(candidates))
        for meta in candidates:
            unit = self.chunks.file_unit(meta)
            resident = self.eviction.is_resident(unit.chunk_id)
            try:
                coords, _ = self._guarded_scan(
                    meta, query,
                    arm=lambda r=resident: not r,
                    fn=lambda m=meta: self.reader.read(m.file_id))
            except RetryExhaustedError as e:
                self._degrade_file(meta, query, degraded, failed_ops, e.op)
                continue
            if not resident:
                scans.append(meta.file_id)
                scan_bytes[meta.node] = (scan_bytes.get(meta.node, 0)
                                         + meta.file_bytes)
                decode_cells.setdefault(meta.node, {}).setdefault(meta.fmt, 0)
                decode_cells[meta.node][meta.fmt] += meta.n_cells
            evicted += self.eviction.admit_online(unit, self.cache)
            queried.append(unit)
            n_in_q = int(points_in_box(coords, query.box).sum())
            cells_in_q += n_in_q
            if reuse_on and resident:
                sliced = n_in_q * meta.cell_bytes
                ship_bytes[unit.chunk_id] = sliced
                if sliced > 0:       # a 0-cell slice reuses nothing
                    reuse_hits += 1
                    reuse_bytes += sliced
        tracer.end(scan_span)
        locations = {cm.chunk_id: self.catalog.by_id(cm.file_id).node
                     for cm in queried}
        jplan = plan_join(queried, locations, query.eps, self.n_nodes,
                          ship_bytes=ship_bytes or None)
        return _QueryPlan(
            query=query, query_index=l, files_considered=len(candidates),
            files_pruned=0, files_scanned=scans,
            scan_bytes_by_node=scan_bytes, decode_cells_by_node=decode_cells,
            queried=queried, queried_cells=cells_in_q, join_plan=jplan,
            opt_time_chunking_s=0.0, refine_stats=RefineStats(),
            online_evicted=evicted, rewrite=rewrite, reuse_hits=reuse_hits,
            reuse_bytes_served=reuse_bytes,
            degraded_boxes=degraded, failed_ops=failed_ops)

    # ------------------------------------------- guarded scan plumbing

    def _guarded_scan(self, meta, query: SimilarityJoinQuery,
                      arm: Callable[[], bool], fn: Callable[[], object]):
        """Run one raw-file scan/decode operation under the ``scan.read``
        fault point and the shared retry policy.

        ``arm()`` decides whether this crossing performs a *real* read
        (first touch / non-resident unit) — only then is the fault point
        consulted. A typed :class:`ScanError` escaping ``fn`` is
        annotated with the queried box; with faults off it propagates to
        the caller (satellite: typed scan errors), with faults on it is
        transient and retried until the budget exhausts
        (:class:`RetryExhaustedError` — the caller degrades the file)."""
        def attempt(attempt_no: int = 0):
            if self.faults is not None and arm():
                self.faults.fault_point("scan.read", file=meta.file_id,
                                        attempt=attempt_no)
            try:
                return fn()
            except ScanError as e:
                if e.box is None:
                    e.box = query.box
                raise
        if self.faults is None:
            return attempt()
        return self.retrier.call("scan.read", attempt)

    def _degrade_file(self, meta, query: SimilarityJoinQuery,
                      degraded: List[Box], failed_ops: List[str],
                      op: str) -> None:
        """Record a file whose scan retried out: the file's overlap with
        the query box becomes a failed sub-box of the eventual
        :class:`~repro_torch.faults.retry.DegradedResult`, and the file is
        skipped for this query (raw files are durable — a later query
        re-attempts with a fresh fault schedule)."""
        inter = meta.box.intersection(query.box)
        if inter is not None:
            degraded.append(inter)
        failed_ops.append(op)

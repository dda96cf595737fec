"""The §4.1 analytical backend: modeled disk/network, real join compute.

This is the seed :class:`repro_torch.core.cluster.RawArrayCluster` execution
path extracted into the backend seam: the container is one box, so disk
and network phases are charged against the calibrated
:class:`~repro_torch.backend.cost_model.CostModel` while the join predicate
itself runs for real (numpy reference or batched torch executor).

The modeled-phase helpers (`modeled_scan_time`, `modeled_net_time`,
`gather_join_tasks`) are shared with
:class:`repro_torch.backend.torch_device.TorchDeviceBackend`, which reports the same
modeled times alongside its measured ones so the two backends stay
directly comparable.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

if TYPE_CHECKING:
    from repro_torch.core.coordinator import (CacheCoordinator, QueryReport,
                                        SimilarityJoinQuery)
from repro_torch.backend.artifacts import (ChunkView, JoinArtifactCache,
                                     subset_token)
from repro_torch.backend.base import ExecutedQuery, record_executed
from repro_torch.backend.cost_model import CostModel
from repro_torch.backend.executors import (JoinTask, count_similar_pairs_np,
                                     make_join_executor)
from repro_torch.faults.errors import RetryExhaustedError
from repro_torch.faults.injector import ChecksumRegistry
from repro_torch.faults.retry import DegradedResult, make_degraded
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry

# Cross-batch multi-query optimization knob: "off" preserves the seed
# per-query execution exactly; "on" deduplicates join tasks by sharing
# signature across each admission batch (execute once, fan counts out).
MQO_MODES = ("off", "on")


class SimulatedBackend:
    """Cost-modeled execution over one process (the paper's simulator)."""

    name = "simulated"

    def __init__(self, n_nodes: int, cost_model: Optional[CostModel] = None,
                 join_fn: Optional[Callable[..., int]] = None,
                 join_backend: str = "numpy", execute_joins: bool = True,
                 device="cuda", impl: str = "kernel", prune: str = "auto",
                 mqo: str = "off"):
        if mqo not in MQO_MODES:
            raise ValueError(f"unknown mqo mode {mqo!r}; "
                             f"expected one of {MQO_MODES}")
        self.n_nodes = n_nodes
        self.cost = cost_model or CostModel()
        self.join_fn = join_fn or count_similar_pairs_np
        self.execute_joins = execute_joins
        self.mqo = mqo
        self.executor = make_join_executor(join_backend, self.join_fn,
                                           device=device, impl=impl,
                                           prune=prune)
        # The torch executor owns a JoinArtifactCache; the backend wires
        # its invalidation into CacheState at bind time (the numpy
        # executor has no host prep to memoize — artifacts stays None).
        self.artifacts: Optional[JoinArtifactCache] = getattr(
            self.executor, "artifacts", None)
        self.coordinator: Optional["CacheCoordinator"] = None
        # Replaced with the coordinator's telemetry bundle at bind time;
        # the no-op default keeps an unbound backend span/metric-free.
        self.telemetry: Telemetry = NULL_TELEMETRY
        # Transient-fault plumbing, adopted from the coordinator at bind
        # time (all None/zero when the faults knob is off — the guarded
        # paths collapse to the seed-exact ones).
        self.faults = None
        self.retrier = None
        self.checksums: Optional[ChecksumRegistry] = None
        self._reroutes = 0
        self._raw_fallbacks = 0
        self._fault_seen: Dict[str, float] = {}

    # ------------------------------------------------------------- binding

    def bind(self, coordinator: "CacheCoordinator") -> None:
        """Attach to the coordinator whose plans this backend executes,
        registering the join-artifact cache as a residency listener so
        memoized prep artifacts are invalidated in lockstep with
        eviction and split-remap (they never outlive their chunk). The
        coordinator's telemetry bundle is adopted here, and its tracer
        handed to the join executor (prep/dispatch spans)."""
        self.coordinator = coordinator
        self.telemetry = coordinator.telemetry
        if self.telemetry.enabled:
            self.executor.tracer = self.telemetry.tracer
        if self.artifacts is not None:
            coordinator.cache.add_listener(self.artifacts)
        # Adopt the coordinator's transient-fault pipeline: the shared
        # injector/retrier (so planner and backend draw from the same
        # deterministic schedules and retry budget), per-chunk payload
        # checksums for corruption faults, and the invariant auditor's
        # backend attachment (enables its device-buffer checks).
        self.faults = coordinator.faults
        self.retrier = coordinator.retrier
        self.checksums = (ChecksumRegistry()
                          if self.faults is not None else None)
        if self.checksums is not None:
            # Lifecycle hygiene: recorded CRCs die with their chunks
            # (split-remap/evict), like every other derived tier.
            coordinator.cache.add_listener(self.checksums)
        self._fault_seen = self._fault_totals()
        if coordinator.auditor is not None:
            coordinator.auditor.attach(self)

    def _record(self, eq: ExecutedQuery) -> ExecutedQuery:
        """Mirror a freshly built ExecutedQuery into the live metrics
        registry (every construction site funnels through here, so
        registry totals equal ``workload_summary`` by construction);
        a no-op with telemetry off."""
        if self.telemetry.enabled:
            record_executed(self.telemetry.registry, eq)
        return eq

    def _queried_coords(self, chunk_id: int, file_id: int,
                        box) -> np.ndarray:
        """Cell coordinates of a queried unit restricted to the query box."""
        # Imported here: the backend package must not import repro_torch.core at
        # module level (repro_torch.core.cluster imports repro_torch.backend).
        from repro_torch.core.geometry import points_in_box
        coords = self.coordinator.chunks.chunk_coords(chunk_id, file_id)
        return coords[points_in_box(coords, box)]

    # ------------------------------------------------------ modeled phases

    def modeled_scan_time(self, report: "QueryReport") -> float:
        """max_n of disk-scan + format-decode time under the cost model."""
        scan_n: Dict[int, float] = {}
        for node, nbytes in report.scan_bytes_by_node.items():
            scan_n[node] = nbytes / self.cost.disk_bw
        for node, per_fmt in report.decode_cells_by_node.items():
            for fmt, cells in per_fmt.items():
                scan_n[node] = (scan_n.get(node, 0.0)
                                + cells / self.cost.decode_rates[fmt])
        return max(scan_n.values(), default=0.0)

    def modeled_net_time(self, report: "QueryReport") -> float:
        """max_n of full-duplex link time for join shipping + placement
        fallback transfers under the cost model."""
        time_net = 0.0
        if report.join_plan is not None:
            per_node = []
            for n in range(self.n_nodes):
                bi = report.join_plan.bytes_in.get(n, 0)
                bo = report.join_plan.bytes_out.get(n, 0)
                per_node.append(max(bi, bo))
            time_net = max(per_node, default=0) / self.cost.net_bw
        return time_net + report.placement_extra_bytes / self.cost.net_bw

    def gather_join_tasks(self, query: "SimilarityJoinQuery",
                          report: "QueryReport",
                          exclude: Optional[set] = None
                          ) -> Tuple[List[JoinTask], Dict[int, int],
                                     Dict[int, np.ndarray], List[
                                         Optional[tuple]]]:
        """Materialize the plan's chunk-pair work: (tasks, per-node
        cell-pair load, per-chunk queried coordinates, per-task sharing
        signatures).

        ``exclude`` names chunk ids whose transfers exhausted their
        retry budget (see ``_guard_transfers``): every pair touching one
        is skipped — its region is served as a degraded sub-box instead
        of crashing the query — and its cell-pair work is not charged.

        With a torch executor each task side is a
        :class:`~repro_torch.backend.artifacts.ChunkView` keyed by chunk
        identity and queried subset, so the executor's artifact cache
        can memoize host-side prep across queries (numpy tasks stay raw
        arrays — the seed shape).

        The signature list runs parallel to ``tasks``: each entry is
        ``((a, subset_a), (b, subset_b), same)`` built from
        :func:`~repro_torch.backend.artifacts.subset_token` — the
        content-addressed identity of the task's computation, which is
        what cross-batch MQO deduplicates on (``None`` marks an
        unshareable task). Signatures are derived for *every* executor
        (the numpy path has no ChunkViews but shares identically).

        A pair with an empty sliced side contributes no matches; under
        the semantic-reuse knob such pairs are skipped before dispatch
        (gated so a custom ``join_fn`` still sees every pair under the
        seed-parity configuration).
        """
        if self.coordinator is None:
            raise RuntimeError("backend not bound — call bind() first")
        cm = {c.chunk_id: c for c in report.queried_chunks}
        tasks: List[JoinTask] = []
        sigs: List[Optional[tuple]] = []
        work_by_node: Dict[int, int] = {}
        coords_cache: Dict[int, np.ndarray] = {}
        views: Dict[int, ChunkView] = {}
        tokens: Dict[int, Optional[tuple]] = {}
        if report.join_plan is None:
            return tasks, work_by_node, coords_cache, sigs
        skip_empty = self.coordinator.reuse == "on"
        for (a, b), node in report.join_plan.pair_node.items():
            if exclude and (a in exclude or b in exclude):
                continue
            for cid in (a, b):
                if cid not in coords_cache:
                    coords_cache[cid] = self._queried_coords(
                        cid, cm[cid].file_id, query.box)
                    tokens[cid] = subset_token(cm[cid].box, query.box)
            ca, cb = coords_cache[a], coords_cache[b]
            work_by_node[node] = (work_by_node.get(node, 0)
                                  + ca.shape[0] * cb.shape[0])
            if skip_empty and (ca.shape[0] == 0 or cb.shape[0] == 0):
                continue
            ta, tb = tokens[a], tokens[b]
            sigs.append(None if ta is None or tb is None
                        else ((a, ta), (b, tb), a == b))
            if self.artifacts is not None:
                for cid in (a, b):
                    if cid not in views:
                        views[cid] = self.artifacts.view(
                            cid, cm[cid].box, query.box, coords_cache[cid])
                tasks.append((node, views[a], views[b], a == b))
            else:
                tasks.append((node, ca, cb, a == b))
        return tasks, work_by_node, coords_cache, sigs

    # ------------------------------------------- failure / replication

    def fail_node(self, node: int) -> Dict[str, float]:
        """Simulate a crash-restart of one node: every cached copy it
        held is lost and the coordinator immediately re-admits what it
        can — cheaply from surviving replicas, else by re-scanning raw
        files. Returns the recovery event's counters (also attached to
        the next ExecutedQuery)."""
        if self.coordinator is None:
            raise RuntimeError("backend not bound — call bind() first")
        return self.coordinator.fail_node(node)

    def _resilience_fields(self, report: "QueryReport") -> Dict[str, object]:
        """Replication/failover counter fields for one ExecutedQuery:
        per-query replica hits plus the coordinator's pending
        round/recovery counters (drained here, so each event is
        attributed to exactly one query — the first executed after it).
        Empty when replication is off and no failure occurred, keeping
        the single-copy ExecutedQuery bit-identical to the seed's."""
        out: Dict[str, object] = {}
        coord = self.coordinator
        if coord is None:
            return out
        pending = coord.drain_exec_counters()
        if coord.replication != "off":
            jp = report.join_plan
            out["replica_hits"] = (int(jp.replica_hits)
                                   if jp is not None else 0)
            out["replicas_dropped"] = int(pending.get("replicas_dropped", 0))
        if "failover_readmits" in pending:
            out["failover_readmits"] = int(pending["failover_readmits"])
            out["recovery_bytes_from_replica"] = int(
                pending.get("recovery_bytes_from_replica", 0))
            out["recovery_bytes_from_raw"] = int(
                pending.get("recovery_bytes_from_raw", 0))
            out["recovery_s"] = float(pending.get("recovery_s", 0.0))
        return out

    # ----------------------------------------------- transient faults

    def _fault_totals(self) -> Dict[str, float]:
        """Cumulative fault-pipeline totals across every shared source:
        the injector, the retrier, the checksum registry, the auditor,
        and the backend-local re-route / raw-fallback counters. Per-query
        attribution is the delta between two snapshots (see
        :meth:`_fault_fields`) — all zeros when the pipeline is off."""
        coord = self.coordinator
        auditor = coord.auditor if coord is not None else None
        return {
            "faults_injected": float(
                self.faults.injected if self.faults is not None else 0),
            "retries": float(
                self.retrier.retries if self.retrier is not None else 0),
            "retry_backoff_s": float(
                self.retrier.backoff_s if self.retrier is not None else 0.0),
            "retry_giveups": float(
                self.retrier.giveups if self.retrier is not None else 0),
            "transfer_reroutes": float(self._reroutes),
            "raw_fallbacks": float(self._raw_fallbacks),
            "checksum_mismatch": float(
                self.checksums.mismatches
                if self.checksums is not None else 0),
            "audit_violations": float(
                auditor.violations_total if auditor is not None else 0),
        }

    def _fault_fields(self, degraded: Optional[DegradedResult]
                      ) -> Dict[str, object]:
        """Fault/retry/audit counter fields for one ExecutedQuery,
        attributed by snapshot delta against the totals recorded at the
        previous query (batched execution attributes its shared
        guard-phase work to the batch's first assembled query — sums
        stay exact). Empty when faults and auditing are both off,
        keeping the default ExecutedQuery bit-identical to the seed's."""
        coord = self.coordinator
        if coord is None or (coord.faults is None and coord.auditor is None):
            return {}
        now = self._fault_totals()
        delta = {k: now[k] - self._fault_seen.get(k, 0.0) for k in now}
        self._fault_seen = now
        out: Dict[str, object] = {}
        if coord.faults is not None:
            out["faults_injected"] = int(delta["faults_injected"])
            out["retries"] = int(delta["retries"])
            out["retry_backoff_s"] = float(delta["retry_backoff_s"])
            out["retry_giveups"] = int(delta["retry_giveups"])
            out["transfer_reroutes"] = int(delta["transfer_reroutes"])
            out["raw_fallbacks"] = int(delta["raw_fallbacks"])
            out["checksum_mismatch"] = int(delta["checksum_mismatch"])
            out["degraded_queries"] = 1 if degraded is not None else 0
            out["degraded"] = degraded
        if coord.auditor is not None:
            out["audit_violations"] = int(delta["audit_violations"])
        return out

    def _guard_transfers(self, query: "SimilarityJoinQuery",
                         report: "QueryReport"
                         ) -> Tuple[set, List[str]]:
        """Arm the ``ship.transfer`` fault point once per planned
        transfer route, retrying with replica re-routing (attempt ``a``
        re-sources from surviving replica ``a % len(replicas)``) and
        falling back to a raw-file re-scan before declaring a chunk
        degraded.

        Returns ``(drop, ops)``: chunk ids whose payload no source could
        produce (their join pairs are excluded and their query overlap
        becomes a degraded sub-box) plus the operation names whose
        budgets were exhausted. Payloads are checksummed on first sight,
        so corruption faults surface as
        :class:`~repro_torch.faults.errors.ChecksumError` and retry like any
        other transient."""
        drop: set = set()
        ops: List[str] = []
        coord = self.coordinator
        if (self.faults is None or coord is None
                or report.join_plan is None):
            return drop, ops
        cm = {c.chunk_id: c for c in report.queried_chunks}
        for cid, src, dst in report.join_plan.transfer_routes:
            if cid in drop or cid not in cm:
                continue
            payload = coord.chunks.chunk_coords(cid, cm[cid].file_id)
            if payload is not None:
                self.checksums.record(cid, payload)
            reps = sorted(coord.cache.replicas_of(cid)) or [src]

            def attempt(a: int, cid=cid, src=src, dst=dst,
                        payload=payload, reps=reps):
                source = src
                if a > 0 and len(reps) > 1:
                    source = reps[a % len(reps)]
                    if source != src:
                        self._reroutes += 1
                got = self.faults.fault_point(
                    "ship.transfer", payload=payload, chunk=cid,
                    src=source, dst=dst, attempt=a)
                if payload is not None and got is not None:
                    self.checksums.verify(cid, got)
                return got

            try:
                self.retrier.call("ship.transfer", attempt)
            except RetryExhaustedError as e:
                # Every replica route is spent — last resort is a fresh
                # raw-file scan of the chunk's home file.
                try:
                    self.retrier.call(
                        "scan.read",
                        lambda a, cid=cid: self.faults.fault_point(
                            "scan.read", chunk=cid, attempt=a))
                    self._raw_fallbacks += 1
                except RetryExhaustedError as e2:
                    ops.extend([e.op, e2.op])
                    drop.add(cid)
        return drop, ops

    def _arm_join_points(self, n_tasks: int) -> None:
        """Arm the executor's declared fault points (host prep and/or
        kernel dispatch) ahead of a join round; raises
        RetryExhaustedError once a budget is spent. The join compute
        itself is pure, so a retry that re-arms the point without
        re-running the kernel is semantically a redo — the result is
        identical by determinism."""
        for point in getattr(self.executor, "fault_points",
                             ("prep.build", "dispatch.kernel")):
            self.retrier.call(
                point,
                lambda a, point=point: self.faults.fault_point(
                    point, tasks=n_tasks, attempt=a))

    def _guarded_count(self, tasks: List[JoinTask], eps: int
                       ) -> Tuple[List[int], Dict[str, float]]:
        """:meth:`_count_tasks` behind the prep/dispatch fault points
        (a direct pass-through when the faults knob is off)."""
        if self.faults is not None:
            self._arm_join_points(len(tasks))
        return self._count_tasks(tasks, eps)

    def _assemble_degraded(self, query: "SimilarityJoinQuery",
                           report: "QueryReport", drop: set,
                           ship_ops: List[str], join_ops: List[str],
                           matches: Optional[int]
                           ) -> Optional[DegradedResult]:
        """Fold planner-side degradation (scan failures recorded on the
        report), dropped transfer chunks, and whole-join failures into
        one :class:`~repro_torch.faults.retry.DegradedResult`; ``None`` when
        the query completed cleanly."""
        boxes = list(report.degraded_boxes)
        ops: List[str] = list(report.failed_ops) + list(ship_ops)
        cm = {c.chunk_id: c for c in report.queried_chunks}
        for cid in sorted(drop):
            inter = cm[cid].box.intersection(query.box)
            if inter is not None:
                boxes.append(inter)
        if join_ops:
            # The whole join round failed: every queried region is
            # unserved regardless of how its data arrived.
            for c in report.queried_chunks:
                inter = c.box.intersection(query.box)
                if inter is not None:
                    boxes.append(inter)
            ops.extend(join_ops)
        if not boxes and not ops:
            return None
        return make_degraded(query.box, tuple(boxes), tuple(ops),
                             matches or 0)

    # ----------------------------------------------------------- execution

    def _cached_result(self, report: "QueryReport") -> ExecutedQuery:
        """The ExecutedQuery of a result-cache hit: the match count is
        served from the coordinator's versioned result tier and nothing
        is scanned, shipped, or joined — every phase time is zero."""
        return self._record(ExecutedQuery(
            report=report, time_scan_s=0.0, time_net_s=0.0,
            time_compute_s=0.0, time_opt_s=0.0,
            matches=report.cached_matches, backend=self.name,
            **self._resilience_fields(report),
            **self._fault_fields(None)))

    def _measured_ship(self, query: "SimilarityJoinQuery",
                       report: "QueryReport",
                       coords_cache: Dict[int, np.ndarray],
                       skip: Optional[set] = None
                       ) -> Tuple[Optional[float], Optional[int]]:
        """Per-query measured transfer replay: the simulated backend
        moves no real bytes (the device backend overrides this with real
        ``Tensor.to(device)`` shipping, skipping ``skip``'s degraded
        chunks)."""
        return None, None

    def _count_tasks(self, tasks: List[JoinTask], eps: int
                     ) -> Tuple[List[int], Dict[str, float]]:
        """Run a task list through the join executor; returns the
        per-task match counts and the executor's dispatch stats."""
        counts = self.executor.count_pairs(tasks, eps)
        return counts, dict(getattr(self.executor, "last_stats", None) or {})

    def execute(self, query: "SimilarityJoinQuery",
                report: "QueryReport") -> ExecutedQuery:
        """Apply the cost model and run the join plan's compute."""
        if report.result_cache_hit:
            return self._cached_result(report)
        time_scan = self.modeled_scan_time(report)
        time_net = self.modeled_net_time(report)

        drop, ship_ops = self._guard_transfers(query, report)
        matches: Optional[int] = None
        stats: Dict[str, float] = {}
        join_ops: List[str] = []
        tasks, work_by_node, _, _ = self.gather_join_tasks(
            query, report, exclude=drop)
        if report.join_plan is not None and self.execute_joins:
            try:
                got, stats = self._guarded_count(tasks, query.eps)
                matches = sum(got)
            except RetryExhaustedError as e:
                join_ops.append(e.op)
                matches = 0
                stats = {}
        time_compute = (max(work_by_node.values(), default=0)
                        / self.cost.cell_pairs_per_sec)

        t_opt = report.opt_time_chunking_s + report.opt_time_evict_place_s
        degraded = self._assemble_degraded(query, report, drop, ship_ops,
                                           join_ops, matches)
        return self._record(ExecutedQuery(
            report=report, time_scan_s=time_scan, time_net_s=time_net,
            time_compute_s=time_compute, time_opt_s=t_opt, matches=matches,
            backend=self.name,
            block_pairs_total=stats.get("block_pairs_total"),
            block_pairs_evaluated=stats.get("block_pairs_evaluated"),
            prep_s=stats.get("prep_s"),
            dispatch_s=stats.get("dispatch_s"),
            artifact_hits=stats.get("artifact_hits"),
            artifact_misses=stats.get("artifact_misses"),
            block_pairs_bitmap_killed=stats.get("block_pairs_bitmap_killed"),
            bitmap_build_s=stats.get("bitmap_build_s"),
            **self._resilience_fields(report),
            **self._fault_fields(degraded)))

    # ----------------------------------- cross-batch MQO (execute_batch)

    @staticmethod
    def _dedup_tasks(gathered: List[Optional[tuple]], eps_list: List[int]
                     ) -> Tuple[List[Tuple[JoinTask, int]],
                                List[Optional[List[int]]],
                                List[Optional[Tuple[int, int, int]]]]:
        """Build the batch's unique-task table: walk every query's tasks
        in admission order, keep the FIRST occurrence of each sharing
        signature (+ eps) as the executed representative, and point
        later subscribers at it. Returns ``(unique, refs, counters)``:
        ``unique`` is the (task, eps) list to execute, ``refs[i]`` maps
        query ``i``'s tasks to unique indices, and ``counters[i]`` is
        its ``(tasks_total, tasks_executed, shared_hits)`` triple
        (``None`` entries mirror result-cache hits, which carry no
        tasks). Signature-less tasks are never shared."""
        unique: List[Tuple[JoinTask, int]] = []
        refs: List[Optional[List[int]]] = []
        counters: List[Optional[Tuple[int, int, int]]] = []
        seen: Dict[tuple, int] = {}
        for g, eps in zip(gathered, eps_list):
            if g is None:
                refs.append(None)
                counters.append(None)
                continue
            tasks, _, _, sigs = g
            my: List[int] = []
            executed = shared = 0
            for task, sig in zip(tasks, sigs):
                key = None if sig is None else (sig, int(eps))
                idx = seen.get(key) if key is not None else None
                if idx is not None:
                    shared += 1
                else:
                    idx = len(unique)
                    unique.append((task, int(eps)))
                    executed += 1
                    if key is not None:
                        seen[key] = idx
                my.append(idx)
            refs.append(my)
            counters.append((len(tasks), executed, shared))
        return unique, refs, counters

    def _execute_unique(self, unique: List[Tuple[JoinTask, int]]
                        ) -> Tuple[List[int], Dict[str, float]]:
        """Execute the deduplicated task table — one dispatch round per
        distinct eps (a batch almost always has one) — and merge the
        executor stats across rounds by summing."""
        counts = [0] * len(unique)
        by_eps: Dict[int, List[int]] = {}
        for idx, (_, eps) in enumerate(unique):
            by_eps.setdefault(eps, []).append(idx)
        merged: Dict[str, float] = {}
        for eps in sorted(by_eps):
            idxs = by_eps[eps]
            got, stats = self._count_tasks([unique[i][0] for i in idxs], eps)
            for i, c in zip(idxs, got):
                counts[i] = int(c)
            for k, v in stats.items():
                if v is not None:
                    merged[k] = merged.get(k, 0) + v
        return counts, merged

    def execute_batch(self, queries: Sequence["SimilarityJoinQuery"],
                      reports: Sequence["QueryReport"]
                      ) -> List[ExecutedQuery]:
        """Execute one admission batch. With ``mqo="off"`` (the seed
        default) this is a per-query :meth:`execute` loop. With
        ``mqo="on"`` the batch's join tasks are deduplicated by sharing
        signature — each distinct ``(chunk_a, chunk_b, subset, eps,
        same)`` task executes exactly once and its match count fans out
        to every subscribing query, so batch kernel work scales with
        *unique* tasks, not query count. Per-query *modeled* phase times
        are unchanged (they describe the plan, keeping MQO-on/off rows
        comparable); the batch-level executor stats (block-pair
        counters, prep/dispatch wall-clock, measured compute) are
        attributed to the batch's last planned query, mirroring how the
        coordinator attributes its per-batch policy-round time."""
        queries = list(queries)
        reports = list(reports)
        if self.mqo != "on":
            return [self.execute(q, r) for q, r in zip(queries, reports)]
        guards = [None if r.result_cache_hit
                  else self._guard_transfers(q, r)
                  for q, r in zip(queries, reports)]
        gathered = [None if g is None
                    else self.gather_join_tasks(q, r, exclude=g[0])
                    for g, q, r in zip(guards, queries, reports)]
        unique, refs, counters = self._dedup_tasks(
            gathered, [q.eps for q in queries])
        counts: List[int] = []
        batch_stats: Dict[str, float] = {}
        batch_failed_op: Optional[str] = None
        if self.execute_joins and unique:
            try:
                if self.faults is not None:
                    self._arm_join_points(len(unique))
                counts, batch_stats = self._execute_unique(unique)
            except RetryExhaustedError as e:
                # The batch's single shared join round failed: every
                # live query is served degraded (zero-count tasks).
                batch_failed_op = e.op
                counts = [0] * len(unique)
                batch_stats = {}
        live = [i for i, g in enumerate(gathered) if g is not None]
        last_live = live[-1] if live else None
        out: List[ExecutedQuery] = []
        for i, (q, r) in enumerate(zip(queries, reports)):
            if gathered[i] is None:
                out.append(self._cached_result(r))
                continue
            drop, ship_ops = guards[i]
            _, work_by_node, coords_cache, _ = gathered[i]
            m_net, m_bytes = self._measured_ship(q, r, coords_cache,
                                                 skip=drop)
            matches: Optional[int] = None
            if r.join_plan is not None and self.execute_joins:
                matches = sum(counts[u] for u in refs[i])
            join_ops = [batch_failed_op] if batch_failed_op else []
            degraded = self._assemble_degraded(q, r, drop, ship_ops,
                                               join_ops, matches)
            stats = batch_stats if i == last_live else {}
            measuring = m_net is not None
            m_compute = (stats.get("measured_compute_s",
                                   0.0 if measuring else None)
                         if measuring else None)
            t_opt = r.opt_time_chunking_s + r.opt_time_evict_place_s
            total, executed, shared = counters[i]
            out.append(self._record(ExecutedQuery(
                report=r, time_scan_s=self.modeled_scan_time(r),
                time_net_s=self.modeled_net_time(r),
                time_compute_s=(max(work_by_node.values(), default=0)
                                / self.cost.cell_pairs_per_sec),
                time_opt_s=t_opt, matches=matches, backend=self.name,
                measured_net_s=m_net, measured_compute_s=m_compute,
                measured_ship_bytes=m_bytes,
                block_pairs_total=stats.get("block_pairs_total"),
                block_pairs_evaluated=stats.get("block_pairs_evaluated"),
                prep_s=stats.get("prep_s"),
                dispatch_s=stats.get("dispatch_s"),
                artifact_hits=stats.get("artifact_hits"),
                artifact_misses=stats.get("artifact_misses"),
                block_pairs_bitmap_killed=stats.get(
                    "block_pairs_bitmap_killed"),
                bitmap_build_s=stats.get("bitmap_build_s"),
                mqo_tasks_total=total, mqo_tasks_executed=executed,
                mqo_shared_hits=shared,
                **self._resilience_fields(r),
                **self._fault_fields(degraded))))
        return out

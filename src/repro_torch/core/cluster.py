"""Shared-nothing cluster façade over the pluggable execution backends.

The *algorithms* (chunking, planning, eviction, placement) and the *join
compute* always run for real; how disk, network, and device placement are
carried out is the backend's job (``repro_torch.backend``):

  * ``backend="simulated"`` — the §4.1 calibrated cost model (the seed
    behavior, extracted into :class:`repro_torch.backend.SimulatedBackend`):
    the container is one box, wall-clock is modeled as

        t(query) = max_n scan_n + max_n net_n + max_n compute_n + t_opt

    with scan_n = scanned_bytes/disk_bw + decoded_cells/decode_rate(fmt),
    net_n = max(bytes_in, bytes_out)/net_bw (full-duplex switch), and
    compute_n = assigned cell-pair work / pair_rate.
  * ``backend="torch_device"`` (the default) — real execution over torch
    devices (:class:`repro_torch.backend.TorchDeviceBackend`): cached
    chunks become device-resident tensors on the devices of the nodes of
    their ``CacheState`` replica set, ship decisions become measured
    cross-device copies, and each node's simjoin batch dispatches to the
    CUDA kernels on that node's device. ``device="cuda"`` (the default)
    maps the nodes onto every visible card and raises without one;
    ``device="cpu"`` runs the same path on the CPU with the kernels'
    plain PyTorch versions.

Join execution backends for the simulated path (``join_backend``):

  * ``"numpy"``  — the reference executor: one blocked numpy evaluation
    per chunk pair (``join_fn`` override preserved).
  * ``"torch"`` (the default) — the batched executor: BLOCK-padded,
    shape-bucketed pair batches dispatched to the ``kernels/simjoin``
    CUDA kernels on ``device`` (``impl="plain"`` runs their plain
    PyTorch versions instead). Its ``prune`` knob selects the grid per
    task: ``"dense"`` (every block pair evaluated), ``"block"``
    (spatially sorted coordinates, host-pruned block pairs handed to the
    pair-list kernel), ``"bitmap"`` (block-sparse plus a cell-exact second stage
    — hierarchical occupancy bitmaps kill bbox-surviving pairs whose
    occupied cells are provably > eps apart), or ``"auto"`` (default —
    block-sparse only where the padded bitmap-refined pair list is
    shorter than the dense grid, so single-block and near-dense chunk
    pairs skip prune overhead). Match counts are identical across all
    four; the work done is reported per query as
    ``ExecutedQuery.block_pairs_evaluated / block_pairs_total`` (plus
    ``block_pairs_bitmap_killed``/``bitmap_build_s`` when the bitmap
    stage engaged).
    Host-side prep (sort/boxes/padding/pair lists) is memoized per
    resident chunk in a ``JoinArtifactCache`` invalidated with cache
    residency; the per-query ``prep_s``/``dispatch_s`` split and
    ``artifact_hits``/``artifact_misses`` land on ``ExecutedQuery``.

This module re-exports the cost model, executors, ``ExecutedQuery``, and
``workload_summary`` from ``repro_torch.backend`` so seed-era imports keep
working.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Any, Callable, List, Optional, Sequence)

if TYPE_CHECKING:  # duck-typed at runtime to avoid a package cycle
    from repro_torch.arrayio.catalog import Catalog, FileReader
from repro_torch.backend import (BACKENDS, CostModel, ExecutedQuery,
                                 JOIN_BACKENDS, JoinTask, NumpyJoinExecutor,
                                 TorchJoinExecutor, count_similar_pairs_np,
                                 make_backend, make_join_executor,
                                 workload_summary)
from repro_torch.core.coordinator import CacheCoordinator, SimilarityJoinQuery
from repro_torch.obs.telemetry import Telemetry

__all__ = ["BACKENDS", "CostModel", "ExecutedQuery", "JOIN_BACKENDS",
           "JoinTask", "NumpyJoinExecutor", "TorchJoinExecutor",
           "RawArrayCluster", "count_similar_pairs_np", "make_backend",
           "make_join_executor", "workload_summary"]


class RawArrayCluster:
    """N worker nodes + coordinator, wired to the caching stack and an
    execution backend (simulated cost model or real torch devices)."""

    def __init__(self, catalog: "Catalog", reader: "FileReader", n_nodes: int,
                 node_budget_bytes: int, policy: str = "cost",
                 placement_mode: str = "dynamic", min_cells: int = 256,
                 cost_model: Optional[CostModel] = None,
                 join_fn: Optional[Callable[..., int]] = None,
                 execute_joins: bool = True,
                 join_backend: str = "torch",
                 budget_scope: str = "global",
                 reuse: str = "off",
                 backend: str = "torch_device",
                 devices: Optional[Sequence[Any]] = None,
                 device: Any = "cuda",
                 impl: str = "kernel",
                 prune: str = "auto",
                 mqo: str = "off",
                 result_cache: str = "off",
                 result_cache_capacity: int = 256,
                 result_cache_ttl_s: Optional[float] = None,
                 replication: str = "off",
                 replica_k: int = 2,
                 replication_threshold: float = 3.0,
                 telemetry: "str | Telemetry | None" = "off",
                 faults: Any = "off",
                 retry: Any = None,
                 audit: str = "auto"):
        if join_fn is not None and join_backend != "numpy":
            raise ValueError(
                "join_fn overrides the join predicate of the numpy "
                "executor; the torch backend always runs the L1 simjoin "
                "kernel — pass one or the other")
        self.catalog = catalog
        self.reader = reader
        self.n_nodes = n_nodes
        self.backend = make_backend(
            backend, n_nodes, cost_model=cost_model, join_fn=join_fn,
            join_backend=join_backend, execute_joins=execute_joins,
            devices=devices, device=device, impl=impl, prune=prune,
            mqo=mqo)
        self.coordinator = CacheCoordinator(
            catalog, reader, n_nodes, node_budget_bytes, policy=policy,
            placement_mode=placement_mode, min_cells=min_cells,
            budget_scope=budget_scope, reuse=reuse,
            result_cache=result_cache,
            result_cache_capacity=result_cache_capacity,
            result_cache_ttl_s=result_cache_ttl_s,
            replication=replication, replica_k=replica_k,
            replication_threshold=replication_threshold,
            telemetry=telemetry, faults=faults, retry=retry, audit=audit)
        self.backend.bind(self.coordinator)

    @property
    def telemetry(self) -> Telemetry:
        """The shared telemetry bundle (``"off"`` default = the no-op
        tracer/registry; pass ``telemetry="on"`` or a ``Telemetry``
        instance to record spans and metrics)."""
        return self.coordinator.telemetry

    def export_trace(self, path: str) -> str:
        """Write the recorded spans as Chrome trace-event JSON to
        ``path`` (Perfetto/``chrome://tracing``-loadable); returns
        ``path``. An off-mode cluster writes an empty—but well-formed—
        trace."""
        return self.telemetry.export_trace(path)

    def summary(self, executed: Sequence[ExecutedQuery]):
        """``workload_summary`` over ``executed``, also surfacing any
        replication/failover events still pending in the coordinator's
        event channel (e.g. a ``fail_node`` after the last query)."""
        return workload_summary(executed, coordinator=self.coordinator)

    # -------------------------------------------------- failure injection

    def fail_node(self, node: int):
        """Simulate a crash-restart of one worker node (see
        ``SimulatedBackend.fail_node``): its cached copies are lost,
        device buffers freed, and the coordinator re-admits what it can
        from surviving replicas or raw files. Returns the recovery
        event's counters."""
        return self.backend.fail_node(node)

    # ------------------------------------------------ backend-state views

    @property
    def cost(self) -> CostModel:
        """The backend's calibrated cost model (seed-API view)."""
        return self.backend.cost

    @property
    def join_fn(self) -> Callable[..., int]:
        """The numpy executor's join predicate (seed-API view)."""
        return self.backend.join_fn

    @property
    def executor(self):
        """The backend's join executor (seed-API view)."""
        return self.backend.executor

    @property
    def execute_joins(self) -> bool:
        """Whether join compute actually runs (seed-API view)."""
        return self.backend.execute_joins

    # ----------------------------------------------------------- execution

    def run_query(self, query: SimilarityJoinQuery) -> ExecutedQuery:
        """Admit one query through the coordinator and execute its plan
        (a result-cache hit report short-circuits execution; a planned
        query's computed match count is written back to the tier).
        Traced as one ``query`` span when telemetry is on."""
        with self.telemetry.tracer.span("query", cat="query"):
            report = self.coordinator.process_query(query)
            executed = self.backend.execute(query, report)
            self.coordinator.record_result(query, executed)
        return executed

    def run_workload(self, queries: Sequence[SimilarityJoinQuery],
                     batch_size: Optional[int] = None
                     ) -> List[ExecutedQuery]:
        """Run a workload. ``batch_size=N`` admits queries through the
        coordinator's batched planning path (shared raw-file scans, one
        eviction/placement round per batch) and the backend's
        ``execute_batch`` (cross-batch join-task dedup under the ``mqo``
        knob); ``None``/1 preserves the per-query admission of the
        paper's experiments. Traced as a root ``workload`` span whose
        direct children (``query`` / ``batch`` spans) tile the run."""
        tracer = self.telemetry.tracer
        root = tracer.begin("workload", cat="workload",
                            queries=len(queries))
        try:
            if batch_size is None or batch_size <= 1:
                return [self.run_query(q) for q in queries]
            out: List[ExecutedQuery] = []
            for i in range(0, len(queries), batch_size):
                batch = list(queries[i:i + batch_size])
                with tracer.span("batch", cat="query", size=len(batch)):
                    reports = self.coordinator.process_batch(batch)
                    executed = self.backend.execute_batch(batch, reports)
                    for q, e in zip(batch, executed):
                        self.coordinator.record_result(q, e)
                out.extend(executed)
            return out
        finally:
            tracer.end(root)

"""Layer 2 of the planning engine: cache residency and byte accounting.

``CacheState`` is the single source of truth for *what is cached where*:
the resident chunk-id set, the chunk -> replica-node map, and the byte
budgets the policy layer plans against. Policies mutate it; the
coordinator and the cluster read it.

Locations are **multi-valued**: every cached chunk maps to a non-empty
tuple of holder nodes, primary-first. A single-copy deployment (the
default, ``replication="off"``) keeps every tuple at length one, which
makes the multi-valued representation bit-for-bit equivalent to the old
single-valued map. Hot-chunk replication (``repro_torch.core.policies.
HotChunkReplication``) appends secondary holders; the join planner
routes pair work to whichever replica is least loaded and eviction
treats secondaries as strictly cheaper to drop than sole copies (they
are simply not re-applied when budget tightens).

All readers and writers outside this module go through the accessor
surface (:meth:`node_of`, :meth:`replicas_of`, :meth:`set_replicas`,
:meth:`assign_locations`, ...) — never through the raw ``locations``
dict — so no caller can hold a stale single-valued view of a
multi-valued entry (``tests/test_replication_failover.py`` greps for
bypasses).

``budget_scope`` makes the budget semantics a first-class option:

  * ``"global"`` — the paper's §4.2.1 setting: all cluster memory is one
    unified pool. Eviction enforces ``sum(bytes) <= B_total`` and
    placement packs against the aggregate, optimizing location only.
  * ``"node"``   — per-node hard limits: placement packs each node
    against ``node_budget_bytes`` and chunks that fit nowhere are
    dropped from cache. This is the regime of real shared-nothing
    deployments where a worker cannot borrow a neighbor's DRAM.

Replica copies are charged at every holder: :meth:`bytes_by_node` sums
per-replica, so under ``budget_scope="node"`` a secondary consumes the
holding node's budget exactly like a primary.
"""
from __future__ import annotations

from typing import (Callable, Dict, FrozenSet, List, Optional, Set, Tuple,
                    Union)

from repro_torch.core.chunk import ChunkMeta
from repro_torch.core.coverage import CoverageIndex

BUDGET_SCOPES = ("global", "node")

# A location value as accepted by the mutator surface: a bare node id
# (normalized to a one-tuple) or an ordered replica tuple, primary-first.
LocationValue = Union[int, Tuple[int, ...]]


def _as_replicas(value: LocationValue) -> Tuple[int, ...]:
    """Normalize a location value to an ordered, de-duplicated replica
    tuple (primary-first). Bare ints become one-tuples — the compat path
    that keeps single-copy callers (and the paper's single-location
    placement results) working unchanged."""
    if isinstance(value, int):
        return (value,)
    seen: Set[int] = set()
    out: List[int] = []
    for n in value:
        n = int(n)
        if n not in seen:
            seen.add(n)
            out.append(n)
    return tuple(out)


class CacheState:
    """Residency, replica locations, and per-node byte accounting.

    Also owns the :class:`~repro_torch.core.coverage.CoverageIndex` over resident
    chunk extents (the semantic-reuse structure): ``drop`` and
    ``remap_split`` keep it in sync point-wise, and ``sync_coverage``
    reconciles it after policy rounds that reassign ``cached`` wholesale
    (eviction/placement replace the resident set rather than mutating it).
    """

    def __init__(self, n_nodes: int, node_budget_bytes: int,
                 budget_scope: str = "global"):
        if budget_scope not in BUDGET_SCOPES:
            raise ValueError(f"unknown budget scope {budget_scope!r}; "
                             f"expected one of {BUDGET_SCOPES}")
        self.n_nodes = n_nodes
        self.node_budget = node_budget_bytes
        self.budget_scope = budget_scope
        self.cached: Set[int] = set()            # resident chunk ids
        # Cached chunk -> ordered holder-node tuple, primary first. Never
        # read or written directly outside this module — use the accessor
        # surface below.
        self.locations: Dict[int, Tuple[int, ...]] = {}
        self.coverage = CoverageIndex()          # boxes of resident chunks
        # Residency listeners (repro_torch.backend.base.DeviceBindingListener):
        # components whose state is derived from resident chunks register
        # here so it moves/frees in lockstep with residency — execution
        # backends committing device buffers (JaxMeshBackend), the
        # join-artifact cache memoizing host-side prep
        # (repro_torch.backend.artifacts.JoinArtifactCache), and the versioned
        # result tier (repro_torch.core.result_cache.ResultCache), which bumps
        # its version stamp on every residency event. Point-wise events
        # fire from ``drop`` and ``remap_split``; ``sync_devices``
        # reconciles after policy rounds that reassign the resident set
        # wholesale.
        self.listeners: List = []

    # ------------------------------------------------------------- budgets

    @property
    def total_budget(self) -> int:
        """Aggregate cache bytes across the cluster (§4.2.1 unified pool)."""
        return self.node_budget * self.n_nodes

    def placement_budgets(self) -> Dict[int, int]:
        """Per-node byte budgets handed to the placement policy."""
        per_node = (self.total_budget if self.budget_scope == "global"
                    else self.node_budget)
        return {n: per_node for n in range(self.n_nodes)}

    # ---------------------------------------------------------- accounting

    def cached_bytes(self, chunk_bytes: Dict[int, int]) -> int:
        """Total resident bytes, charging every replica copy. Retired
        (split) ids missing from the size table contribute nothing —
        their cells live on in the children."""
        return sum(chunk_bytes.get(cid, 0) * max(len(self.replicas_of(cid)),
                                                 1)
                   for cid in self.cached)

    def bytes_by_node(self, chunk_bytes: Dict[int, int]) -> Dict[int, int]:
        """Resident bytes per node: every replica is charged at its
        holder, so the sum over nodes equals the sum of per-replica
        charges (single-copy tuples reproduce the old per-primary map)."""
        out = {n: 0 for n in range(self.n_nodes)}
        for cid in self.cached:
            for node in self.replicas_of(cid):
                out[node] = out.get(node, 0) + chunk_bytes.get(cid, 0)
        return out

    # ----------------------------------------------------------- listeners

    def add_listener(self, listener) -> None:
        """Register a device-binding listener (idempotent)."""
        if listener not in self.listeners:
            self.listeners.append(listener)

    def sync_devices(self) -> None:
        """Ask every device-binding listener to reconcile its committed
        buffers with the current ``cached``/location view — the
        device twin of :meth:`sync_coverage`, run by the coordinator
        after each eviction/placement round."""
        for listener in self.listeners:
            listener.reconcile(self)

    # ----------------------------------------------- location accessors
    # The ONE read/write surface for chunk locations. Everything outside
    # this module (policies, coordinator, backends, result tier) goes
    # through these methods so the multi-valued migration cannot leave a
    # stale single-valued read path behind.

    def node_of(self, chunk_id: int, default: Optional[int] = None
                ) -> Optional[int]:
        """The PRIMARY node of a cached chunk, else ``default`` — the
        compat accessor every old single-valued ``locations.get`` call
        site now routes through."""
        reps = self.locations.get(chunk_id)
        return reps[0] if reps else default

    def location_of(self, chunk_id: int, default: Optional[int] = None
                    ) -> Optional[int]:
        """Seed-API alias of :meth:`node_of` (primary holder)."""
        return self.node_of(chunk_id, default)

    def replicas_of(self, chunk_id: int) -> Tuple[int, ...]:
        """Every node holding a copy of the chunk, primary first; the
        empty tuple for unlocated/unknown ids."""
        return self.locations.get(chunk_id, ())

    def set_replicas(self, chunk_id: int,
                     nodes: LocationValue) -> None:
        """Assign a chunk's full replica set (primary = first element).
        An empty set clears the entry."""
        reps = _as_replicas(nodes)
        if reps:
            self.locations[chunk_id] = reps
        else:
            self.locations.pop(chunk_id, None)

    def ensure_location(self, chunk_id: int, node: int) -> None:
        """Record a location for a chunk that has none yet (setdefault
        semantics — an existing replica set is left untouched)."""
        if chunk_id not in self.locations:
            self.locations[chunk_id] = (node,)

    def clear_location(self, chunk_id: int) -> None:
        """Forget a chunk's replica set (all copies at once)."""
        self.locations.pop(chunk_id, None)

    def assign_locations(self, mapping: Dict[int, LocationValue]) -> None:
        """Wholesale location reassignment — the policy-round path
        (placement results are single-valued; replication re-applies
        secondaries afterwards). Values may be bare node ids or replica
        tuples; each is normalized through :func:`_as_replicas`."""
        self.locations = {cid: _as_replicas(v) for cid, v in mapping.items()
                          if _as_replicas(v)}

    def primary_map(self) -> Dict[int, int]:
        """A ``chunk -> primary node`` snapshot (the seed-era
        single-valued view, for display and legacy assertions)."""
        return {cid: reps[0] for cid, reps in self.locations.items() if reps}

    def location_items(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """Snapshot of ``(chunk, replica-tuple)`` pairs (stable view for
        iteration while mutating)."""
        return list(self.locations.items())

    def location_snapshot(self) -> FrozenSet[Tuple[int, Tuple[int, ...]]]:
        """A hashable snapshot of the full replica map — what the result
        tier's ``reconcile`` diffs to detect relocation (including a
        replica-set change with an unchanged primary)."""
        return frozenset(self.locations.items())

    def audit_locations(self, n_nodes: int) -> List[str]:
        """Well-formedness check over the replica map for the invariant
        auditor: every location tuple must be non-empty and
        duplicate-free, name only nodes in ``[0, n_nodes)``, and belong
        to a resident chunk. Returns human-readable violation strings
        (empty when the map is consistent)."""
        problems: List[str] = []
        for cid, reps in self.locations.items():
            if not reps:
                problems.append(f"chunk {cid} has an empty replica tuple")
                continue
            if len(set(reps)) != len(reps):
                problems.append(
                    f"chunk {cid} replica tuple {reps} has duplicates")
            bad = [n for n in reps if not 0 <= n < n_nodes]
            if bad:
                problems.append(
                    f"chunk {cid} replica tuple {reps} names unknown "
                    f"node(s) {bad} (cluster has {n_nodes})")
            if cid not in self.cached:
                problems.append(
                    f"chunk {cid} has locations {reps} but is not "
                    f"resident")
        return problems

    # ------------------------------------------------------------ mutation

    def remap_split(self, parent_id: int, leaves: List[ChunkMeta]) -> None:
        """A cached chunk was split: children inherit residency, the full
        replica tuple, and coverage-index membership from the retired
        parent (§3.3 split remapping through historical cache state)."""
        self.cached.discard(parent_id)
        reps = self.locations.pop(parent_id, None)
        for cm in leaves:
            self.cached.add(cm.chunk_id)
            if reps:
                self.locations[cm.chunk_id] = reps
        self.coverage.remap_split(parent_id, leaves)
        for listener in self.listeners:
            listener.on_split(parent_id, leaves)

    def drop(self, chunk_id: int) -> None:
        """Remove a chunk (every replica) from residency, locations, and
        the coverage index."""
        self.cached.discard(chunk_id)
        self.locations.pop(chunk_id, None)
        self.coverage.remove(chunk_id)
        for listener in self.listeners:
            listener.on_drop(chunk_id)

    def drop_replica(self, chunk_id: int, node: int) -> bool:
        """Remove ONE copy of a chunk. Returns True if other replicas
        survive (residency intact; listeners see the change at the next
        ``sync_devices``); when the last copy goes this degenerates to a
        full :meth:`drop` (point-wise listener events fire)."""
        reps = self.replicas_of(chunk_id)
        if node not in reps:
            return bool(reps)
        survivors = tuple(n for n in reps if n != node)
        if survivors:
            self.locations[chunk_id] = survivors
            return True
        self.drop(chunk_id)
        return False

    def sync_coverage(self, meta_of: Callable[[int], Optional[ChunkMeta]]
                      ) -> None:
        """Reconcile the coverage index with ``cached`` after a policy
        round. ``meta_of`` resolves a resident chunk id to its metadata
        (``ChunkManager.meta_of``); ids it cannot resolve (retired between
        rounds) are left unindexed and re-enter on the next sync."""
        for cid in self.coverage.ids() - self.cached:
            self.coverage.remove(cid)
        for cid in self.cached - self.coverage.ids():
            meta = meta_of(cid)
            if meta is not None:
                self.coverage.add(meta)

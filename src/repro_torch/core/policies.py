"""Layer 3 of the planning engine: pluggable eviction/placement policies.

The seed coordinator fused policy branching (``if self.policy == ...``)
into the query pipeline. This module turns both decisions into protocol
objects resolved from a string-keyed registry, the way distributed cache
tiers expose policy knobs:

  * ``EvictionPolicy`` — decides *what stays resident* under the byte
    budget. Implementations: cost-based (Alg. 2), LRU, LFU.
  * ``PlacementPolicy`` — decides *which node holds each resident chunk*.
    Implementations: cost-based co-location (Alg. 3), static (home node,
    per-node packing), origin (stay where materialized — the LRU
    baselines' behavior).

A *policy combo* (``PolicySpec``) names a (granularity, eviction,
placement) triple. The seed's three policies map onto combos — including
``file_lru``, which is now just ``lru`` eviction over single-chunk file
units instead of a separate negative-id code path — and new combos
(``chunk_lfu``, ``file_lfu``, ``cost_static``) prove the seam. Register
your own with :func:`register_policy`.

Admission timing differs by granularity, mirroring the paper's baselines:
file units admit *online* (the scan loop consults the live cache, so an
admission earlier in the query can evict a later candidate), while chunk
granularity defers admission to one batch-level round after join
planning (Figure 2's ordering).
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Protocol,
                    Sequence, Set, Tuple)

from repro_torch.core.chunk import ChunkMeta
from repro_torch.core.eviction import (LFUCache, LRUCache, Triple,
                                 cost_based_eviction)
from repro_torch.core.placement import (JoinRecord, PlacementResult,
                                  cost_based_placement, static_placement)

if TYPE_CHECKING:
    from repro_torch.core.cache_state import CacheState
    from repro_torch.core.chunk_manager import ChunkManager


# ---------------------------------------------------------------------------
# Contexts handed to the policies — everything a policy may consult, so
# implementations never reach back into the coordinator.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryAccess:
    """One query's touch set, as seen by the eviction round."""

    query_index: int
    queried: List[ChunkMeta]                  # in access order
    queried_by_file: Dict[int, List[int]]     # file_id -> chunk ids


@dataclasses.dataclass
class EvictionContext:
    """Everything an eviction round may consult (Alg. 2 inputs)."""

    accesses: List[QueryAccess]               # the admission batch, in order
    chunk_bytes: Dict[int, int]
    file_bytes: Dict[int, int]
    state: "CacheState"
    chunks: "ChunkManager"


@dataclasses.dataclass
class PlacementContext:
    """Everything a placement round may consult (Alg. 3 inputs)."""

    replicas: Dict[int, Set[int]]             # cached chunk -> holder nodes
    queried: List[ChunkMeta]                  # batch accesses, in order
    join_history: List[JoinRecord]
    chunk_bytes: Dict[int, int]
    node_budgets: Dict[int, int]
    state: "CacheState"
    home_of: Callable[[int], int]
    decay: float
    history_window: int


# ---------------------------------------------------------------------------
# Protocols
# ---------------------------------------------------------------------------

class EvictionPolicy(Protocol):
    """Decides cache residency. ``finalize_batch`` is the deferred round
    (chunk granularity); ``admit_online``/``is_resident`` drive the online
    file-unit path. Both mutate residency and the replica-location map
    through the ``CacheState`` accessor surface."""

    name: str

    def finalize_batch(self, ctx: EvictionContext) -> int:
        """Run one eviction round over the batch; returns #items evicted."""
        ...

    def admit_online(self, unit: ChunkMeta, state: "CacheState") -> int:
        """Admit one unit during the scan loop; returns #items evicted."""
        ...

    def is_resident(self, chunk_id: int) -> bool:
        """Live residency (online path's scan decision)."""
        ...

    def tracks(self, chunk_id: int) -> bool:
        """Does the policy hold bookkeeping for this id (split remap)?"""
        ...

    def on_split(self, parent_id: int,
                 children: List[Tuple[int, int]]) -> None:
        """Rename a split parent to its (id, nbytes) children."""
        ...

    def discard(self, chunk_id: int) -> None:
        """Placement dropped this chunk from cache: release any
        bookkeeping so the policy's residency view stays in sync."""
        ...


class PlacementPolicy(Protocol):
    """Decides chunk locations for the resident set. Returns the
    ``PlacementResult`` (or ``None`` when locations are implicit) and the
    bytes of any paid fallback transfers."""

    name: str

    def place(self, ctx: PlacementContext
              ) -> Tuple[Optional[PlacementResult], int]:
        """Run one placement round over the resident set."""
        ...


# ---------------------------------------------------------------------------
# Eviction implementations
# ---------------------------------------------------------------------------

class CostEviction:
    """Alg. 2: greedy keep of (query, file, chunk-set) triples by decayed
    rescan-cost-per-uncached-byte. Under batch admission only the LAST
    query's triples are forcibly retained (the paper's 'resident for the
    running query' rule); earlier batch queries have already executed by
    eviction time, so their triples compete through the cost heap as
    maximally-recent history — keeping the budget invariant intact."""

    name = "cost"

    def __init__(self, total_budget: int, decay: float, history_window: int):
        self.total_budget = total_budget
        self.decay = decay
        self.history_window = history_window
        self.state: List[Triple] = []         # Alg. 2 state S

    def finalize_batch(self, ctx: EvictionContext) -> int:
        """One Alg.-2 greedy-keep round over the admission batch."""
        def triples(acc: QueryAccess) -> List[Triple]:
            return [Triple(acc.query_index, fid, frozenset(cids))
                    for fid, cids in acc.queried_by_file.items()]

        current = triples(ctx.accesses[-1])
        history = [t.remap(ctx.chunks.descendants) for t in self.state]
        history = [t for t in history if t.chunk_ids]
        for acc in ctx.accesses[:-1]:
            history.extend(triples(acc))
        res = cost_based_eviction(history, current, self.total_budget,
                                  ctx.chunk_bytes, ctx.file_bytes, self.decay)
        evicted = len(ctx.state.cached - res.cached_chunks)
        self.state = res.state
        if len(self.state) > 4 * self.history_window:
            self.state = sorted(self.state,
                                key=lambda t: -t.query_index
                                )[:4 * self.history_window]
        ctx.state.cached = res.cached_chunks
        return evicted

    def admit_online(self, unit: ChunkMeta, state: "CacheState") -> int:
        """Unsupported: cost eviction has no online file-unit path."""
        raise NotImplementedError(
            "cost-based eviction plans over chunk triples; it has no online "
            "file-unit admission path")

    def is_resident(self, chunk_id: int) -> bool:
        """Unsupported: residency lives in ``CacheState`` for this policy."""
        raise NotImplementedError

    def tracks(self, chunk_id: int) -> bool:
        """Always False: triples remap lazily in ``finalize_batch``."""
        return False                # triples remap lazily in finalize_batch

    def on_split(self, parent_id: int,
                 children: List[Tuple[int, int]]) -> None:
        """No-op — see :meth:`tracks`."""
        pass

    def discard(self, chunk_id: int) -> None:
        """No-op: triples keep the id; it re-enters as uncached bytes in
        the next round's cost computation (the seed behavior)."""
        pass


class _RecencyFrequencyEviction:
    """Shared plumbing for the LRU/LFU baselines: an aggregate-budget item
    cache admitted either online (file units) or deferred (chunk batch)."""

    def __init__(self, cache) -> None:
        self.cache = cache

    def _admit(self, unit: ChunkMeta, state: "CacheState") -> int:
        evicted = self.cache.admit(unit.chunk_id, unit.nbytes)
        for e in evicted:
            state.clear_location(e)
        self.cache.touch(unit.chunk_id)
        return len(evicted)

    def finalize_batch(self, ctx: EvictionContext) -> int:
        count = 0
        for acc in ctx.accesses:
            for cm in acc.queried:
                count += self._admit(cm, ctx.state)
        ctx.state.cached = self.cache.ids()
        return count

    def admit_online(self, unit: ChunkMeta, state: "CacheState") -> int:
        evicted = self._admit(unit, state)
        state.cached = self.cache.ids()
        return evicted

    def is_resident(self, chunk_id: int) -> bool:
        return chunk_id in self.cache

    def tracks(self, chunk_id: int) -> bool:
        return chunk_id in self.cache

    def on_split(self, parent_id: int,
                 children: List[Tuple[int, int]]) -> None:
        self.cache.rename(parent_id, children)

    def discard(self, chunk_id: int) -> None:
        self.cache.remove(chunk_id)


class LRUEviction(_RecencyFrequencyEviction):
    """The paper's §4.1 LRU baseline over file or chunk units."""

    name = "lru"

    def __init__(self, total_budget: int, decay: float, history_window: int):
        super().__init__(LRUCache(total_budget))


class LFUEviction(_RecencyFrequencyEviction):
    """Registry extension: LFU eviction with LRU tie-breaking."""

    name = "lfu"

    def __init__(self, total_budget: int, decay: float, history_window: int):
        super().__init__(LFUCache(total_budget))


# ---------------------------------------------------------------------------
# Placement implementations
# ---------------------------------------------------------------------------

def _default_replicas(ctx: PlacementContext) -> Dict[int, Set[int]]:
    """Join-induced replicas restricted to the retained set, with every
    other cached chunk pinned at its current (or home) node."""
    replicas = {cid: set(nodes) for cid, nodes in ctx.replicas.items()
                if cid in ctx.state.cached}
    for cid in ctx.state.cached:
        if cid not in replicas:
            loc = ctx.state.node_of(cid)
            replicas[cid] = {ctx.home_of(cid) if loc is None else loc}
    return replicas


class CostPlacement:
    """Alg. 3: consolidate replicas to one copy per chunk, maximizing the
    decayed co-location benefit over the join workload history."""

    name = "cost"

    def place(self, ctx: PlacementContext
              ) -> Tuple[Optional[PlacementResult], int]:
        """One Alg.-3 consolidation round; returns (result, paid bytes)."""
        replicas = _default_replicas(ctx)
        result = cost_based_placement(ctx.join_history, replicas,
                                      ctx.chunk_bytes, ctx.node_budgets,
                                      ctx.decay, ctx.history_window)
        for cid in result.dropped:
            ctx.state.cached.discard(cid)
        ctx.state.assign_locations(result.locations)
        extra = sum(ctx.chunk_bytes[c] for c, _ in result.fallback_moves)
        return result, extra


class StaticPlacement:
    """§4.2.4 baseline: every cached chunk lives at its home node."""

    name = "static"

    def place(self, ctx: PlacementContext
              ) -> Tuple[Optional[PlacementResult], int]:
        """Pack every resident chunk at its home node (§4.2.4)."""
        replicas = _default_replicas(ctx)
        home = {cid: ctx.home_of(cid) for cid in replicas}
        result = static_placement(replicas, home, ctx.chunk_bytes,
                                  ctx.node_budgets)
        for cid in result.dropped:
            ctx.state.cached.discard(cid)
        ctx.state.assign_locations(result.locations)
        return result, 0


class OriginPlacement:
    """The LRU baselines' implicit placement: chunks stay where the scan
    materialized them (their home node) and never move. Under
    ``budget_scope="node"`` the home nodes are packed against per-node
    budgets and overflow is dropped from cache (static-style packing);
    under the default global scope eviction already enforced the
    aggregate budget, so locations are recorded without drops."""

    name = "origin"

    def place(self, ctx: PlacementContext
              ) -> Tuple[Optional[PlacementResult], int]:
        """Record home-node locations; pack per node under node scope."""
        if ctx.state.budget_scope == "node":
            replicas = {cid: {ctx.home_of(cid)} for cid in ctx.state.cached}
            home = {cid: ctx.home_of(cid) for cid in replicas}
            result = static_placement(replicas, home, ctx.chunk_bytes,
                                      ctx.node_budgets)
            for cid in result.dropped:
                ctx.state.drop(cid)
            ctx.state.assign_locations(result.locations)
            return result, 0
        for cm in ctx.queried:
            if cm.chunk_id in ctx.state.cached:
                ctx.state.ensure_location(cm.chunk_id,
                                          ctx.home_of(cm.chunk_id))
        return None, 0


# ---------------------------------------------------------------------------
# Replication policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplicationContext:
    """Everything a replication round may consult: the cache state
    (post-eviction/placement, single-valued again), the size table, and
    the coordinator's decayed per-chunk access frequencies."""

    state: "CacheState"
    chunk_bytes: Dict[int, int]
    freq: Dict[int, float]                    # decayed access frequency
    home_of: Callable[[int], int]


class ReplicationPolicy(Protocol):
    """Decides which cached chunks hold extra copies. Runs AFTER the
    eviction and placement rounds (which own residency and primaries and
    plan under full budgets): it re-applies surviving secondaries and
    promotes hot chunks strictly into leftover budget — which is what
    makes secondaries structurally cheaper to drop than sole copies.
    Returns the number of secondaries shed this round."""

    name: str

    def replicate(self, ctx: ReplicationContext) -> int:
        """Run one replication round; returns #secondaries dropped."""
        ...


class NoReplication:
    """The default: single-copy caching, bit-for-bit the pre-replication
    pipeline (the round is a no-op and locations stay one-tuples)."""

    name = "off"

    def __init__(self, k: int = 1, threshold: float = 0.0):
        pass

    def replicate(self, ctx: ReplicationContext) -> int:
        """No-op round: nothing promoted, nothing dropped."""
        return 0


class HotChunkReplication:
    """Promote chunks whose decayed access frequency crosses
    ``threshold`` to ``k`` replicas on the least-loaded nodes, within
    whatever budget the eviction/placement rounds left free.

    Each round: (1) re-apply the previous round's secondaries that are
    still backed by a cached chunk and still fit — a budget squeeze or a
    hotter competitor sheds secondaries FIRST while residency (sole
    copies) is untouched, the replica-aware eviction ordering; (2)
    promote hot chunks (hottest first, deterministic id tie-break) to
    ``k`` copies, choosing for each new copy the node with the fewest
    cached bytes (tie: lowest node id). Secondaries are charged at their
    holder — per-node under ``budget_scope="node"``, against the unified
    pool under ``"global"`` — so a replica can never push a node or the
    cluster over budget."""

    name = "hot"

    def __init__(self, k: int = 2, threshold: float = 3.0):
        if k < 1:
            raise ValueError(f"replica count k must be >= 1, got {k}")
        self.k = k
        self.threshold = threshold
        # Secondaries decided in previous rounds, re-applied (budget
        # permitting) after each placement round wipes locations back to
        # single-valued.
        self._secondaries: Dict[int, Tuple[int, ...]] = {}

    def replicate(self, ctx: ReplicationContext) -> int:
        """One replication round; returns #secondaries shed."""
        state = ctx.state
        budgets = state.placement_budgets()
        used = state.bytes_by_node(ctx.chunk_bytes)
        free_total = state.total_budget - sum(used.values())
        dropped = 0

        def fits(node: int, nb: int) -> bool:
            if state.budget_scope == "node":
                return used.get(node, 0) + nb <= budgets.get(node, 0)
            return free_total >= nb

        def add(cid: int, node: int, nb: int) -> None:
            nonlocal free_total
            state.set_replicas(cid, state.replicas_of(cid) + (node,))
            used[node] = used.get(node, 0) + nb
            free_total -= nb

        # Phase 1: re-apply surviving secondaries under leftover budget.
        for cid in sorted(self._secondaries):
            if cid not in state.cached:
                continue          # chunk evicted: copies died with it
            reps = state.replicas_of(cid)
            if not reps:
                continue
            nb = ctx.chunk_bytes.get(cid, 0)
            for node in self._secondaries[cid]:
                if node in reps or node == reps[0]:
                    continue      # already applied / became the primary
                if nb > 0 and fits(node, nb):
                    add(cid, node, nb)
                    reps = state.replicas_of(cid)
                else:
                    dropped += 1
        # Phase 2: promote hot chunks, hottest first.
        hot = [cid for cid in state.cached
               if ctx.freq.get(cid, 0.0) >= self.threshold]
        hot.sort(key=lambda c: (-ctx.freq.get(c, 0.0), c))
        for cid in hot:
            nb = ctx.chunk_bytes.get(cid, 0)
            if nb <= 0 or not state.replicas_of(cid):
                continue          # unsized or not yet located
            while len(state.replicas_of(cid)) < self.k:
                reps = state.replicas_of(cid)
                cands = [n for n in range(state.n_nodes)
                         if n not in reps and fits(n, nb)]
                if not cands:
                    break
                add(cid, min(cands, key=lambda n: (used.get(n, 0), n)), nb)
        # Remember the end-state secondaries for the next round.
        self._secondaries = {
            cid: state.replicas_of(cid)[1:] for cid in state.cached
            if len(state.replicas_of(cid)) > 1}
        return dropped


REPLICATION_MODES = ("off", "hot")

REPLICATION_REGISTRY: Dict[str, Callable[..., ReplicationPolicy]] = {
    "off": NoReplication,
    "hot": HotChunkReplication,
}


def build_replication(name: str, k: int = 2,
                      threshold: float = 3.0) -> ReplicationPolicy:
    """Construct the replication policy named by ``name`` from the
    registry (``"off"`` = single-copy no-op, ``"hot"`` = hot-chunk
    promotion with ``k`` copies past ``threshold`` decayed accesses)."""
    factory = REPLICATION_REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown replication mode {name!r}; "
                         f"known: {sorted(REPLICATION_REGISTRY)}")
    return factory(k=k, threshold=threshold)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

GRANULARITIES = ("chunk", "file")

EVICTION_REGISTRY: Dict[str, Callable[[int, float, int], EvictionPolicy]] = {
    "cost": CostEviction,
    "lru": LRUEviction,
    "lfu": LFUEviction,
}

PLACEMENT_REGISTRY: Dict[str, Callable[[], PlacementPolicy]] = {
    "dynamic": CostPlacement,
    "static": StaticPlacement,
    "origin": OriginPlacement,
}

# Eviction policies able to admit file units online during the scan loop.
_ONLINE_EVICTION = ("lru", "lfu")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """A named (granularity, eviction, placement) combination."""

    name: str
    granularity: str                 # "chunk" | "file"
    eviction: str                    # EVICTION_REGISTRY key
    placement: str                   # PLACEMENT_REGISTRY key

    def validate(self) -> None:
        """Reject unknown keys and invalid granularity/eviction pairings."""
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.eviction not in EVICTION_REGISTRY:
            raise ValueError(f"unknown eviction policy {self.eviction!r}; "
                             f"known: {sorted(EVICTION_REGISTRY)}")
        if self.placement not in PLACEMENT_REGISTRY:
            raise ValueError(f"unknown placement policy {self.placement!r}; "
                             f"known: {sorted(PLACEMENT_REGISTRY)}")
        if self.granularity == "file" and \
                self.eviction not in _ONLINE_EVICTION:
            raise ValueError(
                f"file granularity requires an online-capable eviction "
                f"policy ({_ONLINE_EVICTION}), got {self.eviction!r}")


POLICY_REGISTRY: Dict[str, PolicySpec] = {}


def register_policy(spec: PolicySpec) -> PolicySpec:
    """Validate and install a policy combo under ``spec.name``."""
    spec.validate()
    POLICY_REGISTRY[spec.name] = spec
    return spec


# The seed's three policies, now expressed as combos...
register_policy(PolicySpec("cost", "chunk", "cost", "dynamic"))
register_policy(PolicySpec("chunk_lru", "chunk", "lru", "origin"))
register_policy(PolicySpec("file_lru", "file", "lru", "origin"))
# ...plus new combinations the policy seam makes one-liners.
register_policy(PolicySpec("cost_static", "chunk", "cost", "static"))
register_policy(PolicySpec("chunk_lfu", "chunk", "lfu", "origin"))
register_policy(PolicySpec("file_lfu", "file", "lfu", "origin"))

POLICIES = tuple(POLICY_REGISTRY)


def resolve_policy(name: str, placement_mode: str = "dynamic") -> PolicySpec:
    """Look up a policy combo. ``placement_mode`` preserves the seed API:
    ``policy="cost", placement_mode="static"`` selects static placement."""
    if placement_mode not in ("dynamic", "static"):
        raise ValueError(f"unknown placement mode {placement_mode!r}")
    spec = POLICY_REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown policy {name!r}; "
                         f"known: {sorted(POLICY_REGISTRY)}")
    if spec.placement == "dynamic" and placement_mode == "static":
        spec = dataclasses.replace(spec, placement="static")
    return spec


def build_eviction(spec: PolicySpec, total_budget: int, decay: float,
                   history_window: int) -> EvictionPolicy:
    """Construct the eviction policy named by ``spec.eviction``."""
    return EVICTION_REGISTRY[spec.eviction](total_budget, decay,
                                            history_window)


def build_placement(spec: PolicySpec) -> PlacementPolicy:
    """Construct the placement policy named by ``spec.placement``."""
    return PLACEMENT_REGISTRY[spec.placement]()

"""Versioned result-cache tier: O(1) serving of exact repeat queries.

The coordinator's planning pipeline (chunking refinement, join planning,
eviction/placement) is run for every admitted query — but on the skewed
workloads the paper targets ("millions of users" traffic is Zipf-shaped)
most queries are *exact repeats* of a recent query, and a similarity
join's answer is a pure function of the raw data, the query box, and
``eps``. :class:`ResultCache` is a small read-through tier in front of
the planner (Szépkúti, *Caching in Multidimensional Databases*,
PAPERS.md): :meth:`repro_torch.core.coordinator.CacheCoordinator.process_batch`
consults it *before* planning, so a hit skips chunking, join planning,
the policy round, and backend execution entirely.

Entries are **version-stamped**: the cache registers on
:attr:`repro_torch.core.cache_state.CacheState.listeners` (the same hook
surface device buffers and join artifacts ride) and bumps its version on
every residency event — point-wise ``on_drop``/``on_split``, and a
``reconcile`` snapshot diff that catches the wholesale resident-set
reassignment of eviction/placement rounds (including admissions, which
never go through a point-wise hook). A lookup only serves an entry
stored at the *current* version, so no result computed against a
previous cache configuration is ever served after an
evict -> re-admit -> split sequence. Match counts would in fact survive
such churn (they depend only on the raw cells), but the served planning
observables (``queried_cells``, cache occupancy) would not — the stamp
keeps every served field honest and makes invalidation auditable
(``stale_drops``).

Capacity is LRU-bounded and entries optionally expire after ``ttl_s``
seconds (bounded staleness, the read-through pattern from the
scalability-patterns blueprint in SNIPPETS.md). The ``clock`` is
injectable for deterministic TTL tests.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple, Union

from repro_torch.obs.clock import Clock, as_clock

if TYPE_CHECKING:  # geometry/type-only imports; no runtime cycle
    from repro_torch.core.cache_state import CacheState
    from repro_torch.core.chunk import ChunkMeta
    from repro_torch.core.geometry import Box

# Canonical lookup key of a query: (box.lo, box.hi, eps) as plain int
# tuples — Box is closed and normalized (lo <= hi), so two queries with
# equal keys denote the identical cell region and join radius.
ResultKey = Tuple[Tuple[int, ...], Tuple[int, ...], int]

RESULT_CACHE_MODES = ("off", "on")


@dataclasses.dataclass
class ResultEntry:
    """One cached query answer plus the planning observables served with
    it; ``version`` is the residency stamp it was computed under and
    ``stored_at`` the (injectable-clock) store time for TTL expiry."""

    matches: int
    queried_cells: int
    cached_bytes_after: int
    cached_chunks_after: int
    version: int
    stored_at: float


class ResultCache:
    """LRU+TTL bounded, residency-versioned map from canonical query
    keys to executed results.

    Counters: ``hits``/``misses`` (every lookup lands in exactly one),
    ``stale_drops`` (entry found but stamped with an older residency
    version), ``expired_drops`` (TTL), ``capacity_evictions`` (LRU), and
    ``invalidations`` (version bumps). A stale or expired entry counts
    as a miss and is dropped eagerly.
    """

    def __init__(self, capacity: int = 256, ttl_s: Optional[float] = None,
                 clock: Union[Clock, Callable[[], float], None] = None):
        if capacity <= 0:
            raise ValueError(f"result-cache capacity must be positive, "
                             f"got {capacity}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        # Accepts a repro_torch.obs Clock or a bare () -> float callable (the
        # seed-era signature); None falls back to the shared monotonic
        # clock. This removed the module's direct time.monotonic call.
        self._clock = as_clock(clock).now
        self._entries: "OrderedDict[ResultKey, ResultEntry]" = OrderedDict()
        # Residency version stamp + the snapshot reconcile diffs against.
        self.version = 0
        self._snapshot: Tuple[frozenset, frozenset] = (frozenset(),
                                                       frozenset())
        self.hits = 0
        self.misses = 0
        self.stale_drops = 0
        self.expired_drops = 0
        self.capacity_evictions = 0
        self.invalidations = 0

    # ------------------------------------------------------------ keying

    @staticmethod
    def key_of(box: "Box", eps: int) -> ResultKey:
        """The canonical lookup key of a query ``(box, eps)``."""
        return (tuple(int(x) for x in box.lo),
                tuple(int(x) for x in box.hi), int(eps))

    # ------------------------------------------------------ lookup/store

    def lookup(self, key: ResultKey) -> Optional[ResultEntry]:
        """Read-through probe: the entry for ``key`` if present, stamped
        with the current residency version, and within TTL — else
        ``None`` (stale/expired entries are dropped eagerly). A served
        entry is LRU-refreshed."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        if e.version != self.version:
            del self._entries[key]
            self.stale_drops += 1
            self.misses += 1
            return None
        if self.ttl_s is not None and self._clock() - e.stored_at > self.ttl_s:
            del self._entries[key]
            self.expired_drops += 1
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e

    def store(self, key: ResultKey, matches: int, queried_cells: int = 0,
              cached_bytes_after: int = 0,
              cached_chunks_after: int = 0) -> None:
        """Write-back after a planned query executed: stamp the entry
        with the current residency version and evict LRU past capacity."""
        self._entries[key] = ResultEntry(
            matches=int(matches), queried_cells=int(queried_cells),
            cached_bytes_after=int(cached_bytes_after),
            cached_chunks_after=int(cached_chunks_after),
            version=self.version, stored_at=self._clock())
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.capacity_evictions += 1

    def __len__(self) -> int:
        """Stored entries (stale/expired ones linger until probed or
        evicted — the version stamp, not presence, is the validity
        source of truth)."""
        return len(self._entries)

    # ------------------------------------------------------ invalidation

    def bump(self) -> None:
        """Advance the residency version: every stored entry becomes
        stale at once (dropped lazily on probe — O(1) invalidation, the
        versioned-key pattern)."""
        self.version += 1
        self.invalidations += 1

    # ------------------------- residency listener (CacheState hooks) --

    def on_drop(self, chunk_id: int) -> None:
        """A chunk left the cache: results computed under the previous
        residency may serve observables that no longer hold — bump."""
        self.bump()

    def on_split(self, parent_id: int, leaves: List["ChunkMeta"]) -> None:
        """A cached chunk split (ids reminted): bump, same reasoning."""
        self.bump()

    def reconcile(self, state: "CacheState") -> None:
        """Post-round sync: diff the resident set + location map against
        the last seen snapshot and bump on any change. This is what
        catches *admissions* — policy rounds assign ``state.cached``
        wholesale, so no point-wise hook fires for a newly admitted
        chunk. A round that leaves residency untouched keeps the version
        (warm repeats stay servable)."""
        snap = (frozenset(state.cached), state.location_snapshot())
        if snap != self._snapshot:
            self._snapshot = snap
            self.bump()

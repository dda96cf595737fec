"""Cache eviction: cost-based (Alg. 2) plus the paper's two LRU baselines.

The cache *state* is the set of triples ``(Q_l, f_i, {C_j})`` — the chunks of
file ``f_i`` accessed by query ``Q_l`` (§3.3). The cost of keeping a triple:

    cost(Q_l, f_i, {C_j}) = w(l) * size(f_i) / sum(size(uncached C_j))

with exponentially decayed query weights ``w(l) = decay**l``. A triple whose
chunks are all already retained costs nothing to keep (ratio = +inf). Costs
are evaluated in log2 space so 100-query workloads don't overflow.

Alg. 2 is a greedy *keep* loop: seed the new state with the current query's
triples, then repeatedly keep the highest-cost triple that fits the cumulated
budget. Keeping a triple raises the cost of every other triple sharing chunks
with it (their uncached denominator shrinks) — implemented with a max-heap
and versioned lazy re-insertion, O(N log N) as in the paper.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import OrderedDict
from typing import Dict, FrozenSet, Iterable, List, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Triple:
    """(Q_l, f_i, {C_j}) — chunks of file f_i accessed at query index l."""

    query_index: int
    file_id: int
    chunk_ids: FrozenSet[int]

    def remap(self, descendants) -> "Triple":
        """Remap split chunk ids onto their current leaves."""
        out: Set[int] = set()
        for cid in self.chunk_ids:
            out.update(descendants(cid))
        return Triple(self.query_index, self.file_id, frozenset(out))


@dataclasses.dataclass
class EvictionResult:
    """Output of one Alg.-2 round: the new state S' and retained chunks."""

    state: List[Triple]            # the retained triples S'
    cached_chunks: Set[int]        # union of chunk ids across S'
    kept_from_history: int
    dropped_from_history: int


def _log_cost(triple: Triple, cached: Set[int], chunk_bytes: Dict[int, int],
              file_bytes: Dict[int, int], log2_decay: float) -> float:
    uncached = sum(chunk_bytes[c] for c in triple.chunk_ids if c not in cached)
    if uncached == 0:
        return math.inf
    return (triple.query_index * log2_decay
            + math.log2(file_bytes[triple.file_id]) - math.log2(uncached))


def _uncached_bytes(triple: Triple, cached: Set[int],
                    chunk_bytes: Dict[int, int]) -> int:
    return sum(chunk_bytes[c] for c in triple.chunk_ids if c not in cached)


def cost_based_eviction(history: Sequence[Triple],
                        current: Sequence[Triple],
                        budget_bytes: int,
                        chunk_bytes: Dict[int, int],
                        file_bytes: Dict[int, int],
                        decay: float = 2.0) -> EvictionResult:
    """Alg. 2. ``current`` triples are always retained (they are resident for
    the running query; if they alone exceed the budget the loop simply keeps
    nothing else). Returns the updated state S' and the retained chunk set."""
    log2_decay = math.log2(decay)
    state: List[Triple] = list(current)
    cached: Set[int] = set()
    for t in current:
        cached.update(t.chunk_ids)
    used = sum(chunk_bytes[c] for c in cached)

    triples = list(history)
    # chunk -> indices of history triples containing it (for line 6 updates).
    by_chunk: Dict[int, List[int]] = {}
    for i, t in enumerate(triples):
        for c in t.chunk_ids:
            by_chunk.setdefault(c, []).append(i)

    version = [0] * len(triples)
    accepted = [False] * len(triples)
    heap: List[Tuple[float, int, int, int]] = []  # (-logcost, tiebreak, ver, idx)
    for i, t in enumerate(triples):
        lc = _log_cost(t, cached, chunk_bytes, file_bytes, log2_decay)
        heapq.heappush(heap, (-lc, -t.query_index, 0, i))

    deferred: List[int] = []
    kept = 0
    while heap:
        neg_lc, _, ver, i = heapq.heappop(heap)
        if accepted[i] or ver != version[i]:
            continue
        need = _uncached_bytes(triples[i], cached, chunk_bytes)
        if need > 0 and used + need > budget_bytes:
            deferred.append(i)
            continue
        # Keep it.
        accepted[i] = True
        kept += 1
        state.append(triples[i])
        used += need
        newly = [c for c in triples[i].chunk_ids if c not in cached]
        cached.update(newly)
        # Line 6: boost triples sharing the newly cached chunks.
        touched: Set[int] = set()
        for c in newly:
            touched.update(by_chunk.get(c, ()))
        for j in touched:
            if accepted[j]:
                continue
            version[j] += 1
            lc = _log_cost(triples[j], cached, chunk_bytes, file_bytes,
                           log2_decay)
            heapq.heappush(heap, (-lc, -triples[j].query_index, version[j], j))
        # Newly cached bytes may have made deferred triples fit (or free).
        if deferred:
            for j in deferred:
                if not accepted[j]:
                    version[j] += 1
                    lc = _log_cost(triples[j], cached, chunk_bytes, file_bytes,
                                   log2_decay)
                    heapq.heappush(heap, (-lc, -triples[j].query_index,
                                          version[j], j))
            deferred.clear()
    return EvictionResult(state=state, cached_chunks=cached,
                          kept_from_history=kept,
                          dropped_from_history=len(triples) - kept)


# --------------------------------------------------------------------------
# Baselines (§4.1): distributed LRU at file and chunk granularity.
# --------------------------------------------------------------------------

class LRUCache:
    """Distributed-unified-memory LRU over items with sizes (file or chunk
    granularity). ``touch`` marks use; ``admit`` inserts then evicts LRU
    items until the aggregate budget is respected."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._items: "OrderedDict[int, int]" = OrderedDict()  # id -> bytes

    def __contains__(self, item_id: int) -> bool:
        return item_id in self._items

    @property
    def used_bytes(self) -> int:
        """Total bytes of resident items."""
        return sum(self._items.values())

    def ids(self) -> Set[int]:
        """The resident item-id set."""
        return set(self._items.keys())

    def touch(self, item_id: int) -> None:
        """Mark an item most-recently-used (no-op when absent)."""
        if item_id in self._items:
            self._items.move_to_end(item_id)

    def admit(self, item_id: int, nbytes: int) -> List[int]:
        """Insert/refresh an item; returns ids evicted to make room. Items
        larger than the whole budget are not admitted (paper's LRU baselines
        never split items)."""
        evicted: List[int] = []
        if nbytes > self.budget:
            return evicted
        if item_id in self._items:
            self._items.move_to_end(item_id)
            return evicted
        self._items[item_id] = nbytes
        used = self.used_bytes
        while used > self.budget:
            old_id, old_bytes = self._items.popitem(last=False)
            if old_id == item_id:
                # Shouldn't happen (just admitted to MRU end) — guard anyway.
                self._items[item_id] = nbytes
                break
            evicted.append(old_id)
            used -= old_bytes
        return evicted

    def remove(self, item_id: int) -> None:
        """Forget an item without counting it as an eviction."""
        self._items.pop(item_id, None)

    def rename(self, old_id: int, new_ids: Iterable[Tuple[int, int]]) -> None:
        """Replace a split item by its children, preserving recency order as
        best as an LRU can (children inherit the parent's slot)."""
        if old_id not in self._items:
            return
        items = list(self._items.items())
        self._items.clear()
        for iid, nb in items:
            if iid == old_id:
                for cid, cb in new_ids:
                    self._items[cid] = cb
            else:
                self._items[iid] = nb


class LFUCache:
    """Distributed-unified-memory LFU over items with sizes. Victims are
    the least-frequently-used items, recency-LRU among equal frequencies
    (the classic LFU tie-break). Same admit/touch/rename surface as
    ``LRUCache`` so the policy layer can swap them freely."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._bytes: Dict[int, int] = {}
        self._freq: Dict[int, int] = {}
        self._clock: Dict[int, int] = {}
        self._tick = 0

    def __contains__(self, item_id: int) -> bool:
        return item_id in self._bytes

    @property
    def used_bytes(self) -> int:
        """Total bytes of resident items."""
        return sum(self._bytes.values())

    def ids(self) -> Set[int]:
        """The resident item-id set."""
        return set(self._bytes.keys())

    def touch(self, item_id: int) -> None:
        """Bump an item's frequency and recency clock (no-op when absent)."""
        if item_id in self._bytes:
            self._tick += 1
            self._freq[item_id] += 1
            self._clock[item_id] = self._tick

    def admit(self, item_id: int, nbytes: int) -> List[int]:
        """Insert/refresh an item; returns ids evicted to make room. Items
        larger than the whole budget are never admitted."""
        evicted: List[int] = []
        if nbytes > self.budget:
            return evicted
        self._tick += 1
        if item_id in self._bytes:
            self._freq[item_id] += 1
            self._clock[item_id] = self._tick
            return evicted
        self._bytes[item_id] = nbytes
        self._freq[item_id] = 1
        self._clock[item_id] = self._tick
        used = self.used_bytes
        while used > self.budget:
            victim = min((i for i in self._bytes if i != item_id),
                         key=lambda i: (self._freq[i], self._clock[i]),
                         default=None)
            if victim is None:
                break
            used -= self._bytes[victim]
            self.remove(victim)
            evicted.append(victim)
        return evicted

    def remove(self, item_id: int) -> None:
        """Forget an item without counting it as an eviction."""
        self._bytes.pop(item_id, None)
        self._freq.pop(item_id, None)
        self._clock.pop(item_id, None)

    def rename(self, old_id: int, new_ids: Iterable[Tuple[int, int]]) -> None:
        """Replace a split item by its children; children inherit the
        parent's frequency and clock."""
        if old_id not in self._bytes:
            return
        freq, clock = self._freq[old_id], self._clock[old_id]
        self.remove(old_id)
        for cid, cb in new_ids:
            self._bytes[cid] = cb
            self._freq[cid] = freq
            self._clock[cid] = clock

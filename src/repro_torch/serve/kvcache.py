"""Paged KV cache management with the paper's cost model (beyond-paper
integration, DESIGN.md §2).

Mapping onto §3 of the paper:
  * chunk  -> KV page (``page_size`` tokens of one request's prefix)
  * file   -> a request's full prefix: a miss on *any* page of a retained
              prefix forces recomputing the *whole* prefill — exactly the
              "one uncached chunk => full file scan" structure that makes
              chunk-LRU suboptimal for raw arrays (§3.3)
  * query  -> a serving request (weighted by recency, decayed like w_Q)
  * placement -> assigning requests to replica groups so shared prefix
              pages are co-resident (Alg. 3 over the sharing relation)

Adaptation note (DESIGN.md §7): Alg. 2's *triple* granularity (keep all of a
query's chunks or none) degenerates in serving whenever the byte budget is
smaller than one request's working set — the greedy then thrashes between
whole requests and shared prefixes never survive. The serving cost is
therefore evaluated per *page* with the same exponential query decay:

    score(page) = sum_r  decay^(l_r - l_now) * (1 + prefix_position_r)

where prefix_position upweights early pages (losing them invalidates the
longest usable prefix — the analogue of "one miss => full file scan"). The
verbatim Alg. 2 runs in the reference's input pipeline (repro/data) where
query working sets fit; decay defaults to 1.3 here (frequency matters more than recency
for prefix reuse). Prefix sharing is content-addressed: page key =
hash(tokens up to the page end).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.eviction import LRUCache, Triple, cost_based_eviction
from repro_torch.core.placement import JoinRecord, cost_based_placement


def _prefix_hashes(tokens: Sequence[int], page_size: int) -> List[str]:
    out = []
    h = hashlib.sha1()
    for i in range(0, len(tokens) - len(tokens) % page_size, page_size):
        h.update(bytes(str(list(tokens[i:i + page_size])), "ascii"))
        out.append(h.hexdigest()[:16])
    return out


@dataclasses.dataclass
class PageMeta:
    """One resident page: id, prefix-closed content key, bytes."""
    page_id: int
    key: str                      # content hash (prefix-closed)
    nbytes: int


@dataclasses.dataclass
class AllocResult:
    """What ``PagedKVCacheManager.allocate`` did for one request."""
    page_ids: List[int]
    hit_pages: int                # served from cache (prefill skipped)
    new_pages: int
    evicted_pages: List[int]
    recompute_tokens: int         # prefill tokens actually recomputed


class PagedKVCacheManager:
    """Content-addressed page pool under a byte budget with cost-based or
    LRU eviction."""

    def __init__(self, *, page_size: int, budget_bytes: int,
                 page_bytes: int, policy: str = "cost", decay: float = 1.3):
        assert policy in ("cost", "lru")
        self.page_size = page_size
        self.budget = budget_bytes
        self.page_bytes = page_bytes
        self.policy = policy
        self.decay = decay
        self._next_id = 0
        self.by_key: Dict[str, PageMeta] = {}
        self.by_id: Dict[int, PageMeta] = {}
        self.history: List[Triple] = []      # (request idx, req id, pages)
        self.request_count = 0
        self.lru = LRUCache(budget_bytes)
        self.share_pairs: List[JoinRecord] = []

    # ---------------------------------------------------------- allocation

    def _new_page(self, key: str) -> PageMeta:
        meta = PageMeta(self._next_id, key, self.page_bytes)
        self._next_id += 1
        self.by_key[key] = meta
        self.by_id[meta.page_id] = meta
        return meta

    def allocate(self, request_id: int, tokens: Sequence[int]) -> AllocResult:
        """Admit a request's prompt; returns its page list and what must be
        recomputed. Eviction runs after admission (the current request is
        always resident, like the current query in Alg. 2)."""
        self.request_count += 1
        l = self.request_count
        keys = _prefix_hashes(tokens, self.page_size)
        page_ids: List[int] = []
        hits = 0
        shared_with: Set[int] = set()
        for k in keys:
            meta = self.by_key.get(k)
            if meta is not None and self._resident(meta.page_id):
                hits += 1
            elif meta is None:
                meta = self._new_page(k)
            page_ids.append(meta.page_id)
        # A prefix is usable only up to the first non-resident page: pages
        # after a miss must be recomputed even if individually cached.
        usable = 0
        for pid in page_ids:
            if self._resident(pid):
                usable += 1
            else:
                break
        recompute = (len(keys) - usable) * self.page_size + \
            len(tokens) % self.page_size

        evicted = self._admit(l, request_id, page_ids)
        # Sharing relation for placement: pages reused across requests.
        for t in self.history[-8:]:
            common = set(page_ids) & t.chunk_ids
            if common and t.file_id != request_id:
                shared_with.add(t.file_id)
        self.history.append(Triple(l, request_id, frozenset(page_ids)))
        if len(self.history) > 256:
            self.history = self.history[-256:]
        return AllocResult(page_ids=page_ids, hit_pages=hits,
                           new_pages=len(keys) - hits,
                           evicted_pages=evicted,
                           recompute_tokens=recompute)

    def _resident(self, page_id: int) -> bool:
        if self.policy == "lru":
            return page_id in self.lru
        return page_id in self._resident_set

    # --------------------------------------------------------- eviction ---

    @property
    def _resident_set(self) -> Set[int]:
        if not hasattr(self, "_res"):
            self._res: Set[int] = set()
        return self._res

    def _admit(self, l: int, request_id: int,
               page_ids: List[int]) -> List[int]:
        if self.policy == "lru":
            evicted: List[int] = []
            for pid in page_ids:
                evicted.extend(self.lru.admit(pid, self.page_bytes))
                self.lru.touch(pid)
            return evicted
        # Page-granular decayed-frequency score with a prefix-position term
        # (see module docstring for why Alg. 2's triple granularity is
        # adapted here).
        scores: Dict[int, float] = {}

        def credit(qidx: int, pages) -> None:
            n = len(pages)
            for k, pid in enumerate(pages):
                w = self.decay ** (qidx - l) * (1.0 + (n - k) / max(n, 1))
                scores[pid] = scores.get(pid, 0.0) + w

        for t in self.history:
            credit(t.query_index, sorted(t.chunk_ids))
        credit(l, page_ids)
        candidates = set(self._resident_set) | set(page_ids)
        max_pages = max(1, self.budget // self.page_bytes)
        keep = sorted(candidates, key=lambda p: -scores.get(p, 0.0)
                      )[:max_pages]
        before = self._resident_set
        self._res = set(keep)
        return sorted(before - self._res)

    # --------------------------------------------------------- placement --

    def assign_replica_groups(self, n_groups: int,
                              group_budget_bytes: int) -> Dict[int, int]:
        """Place resident pages onto serving replica groups, co-locating
        pages shared across recent requests (Alg. 3)."""
        resident = (self.lru.ids() if self.policy == "lru"
                    else set(self._resident_set))
        pairs = []
        for t in self.history[-32:]:
            pages = sorted(p for p in t.chunk_ids if p in resident)
            pairs.append(JoinRecord(t.query_index,
                                    tuple((a, b) for i, a in enumerate(pages)
                                          for b in pages[i + 1:])))
        replicas = {p: set(range(n_groups)) for p in resident}
        bytes_ = {p: self.page_bytes for p in resident}
        budgets = {g: group_budget_bytes for g in range(n_groups)}
        res = cost_based_placement(pairs, replicas, bytes_, budgets,
                                   self.decay)
        return res.locations

    # ------------------------------------------------------------- stats --

    @property
    def resident_bytes(self) -> int:
        """Bytes of the pages now resident under the budget."""
        if self.policy == "lru":
            return self.lru.used_bytes
        return len(self._resident_set) * self.page_bytes

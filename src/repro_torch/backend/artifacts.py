"""Join-artifact cache: memoized host-side join prep riding residency.

The block-sparse simjoin path pays a host-side preparation cost
per chunk pair on EVERY query: ``spatial_sort`` over each coordinate
set, per-block bounding boxes, sentinel padding to the kernel's
coordinate-major layout, and the eps-pruned block-pair list. The paper's
whole premise is that a workload of overlapping queries repeatedly
touches the *same* resident chunks — so those derived artifacts are
recomputed over identical inputs again and again.

:class:`JoinArtifactCache` memoizes them *alongside the resident data*:

  * per ``(chunk, queried-subset)`` — the spatially sorted coordinate
    array and its sentinel-padded coordinate-major forms (one per
    sentinel sign, i.e. per join side);
  * per ``(chunk_a, chunk_b, block, eps, same)`` — the pruned
    block-pair list from ``prune.build_block_pairs`` together with its
    dense-grid denominator;
  * per ``(chunk, queried-subset, block, scale)`` — the hierarchical
    occupancy bitmap sidecars from ``prune.build_bitmaps`` (the
    cell-exact prune stage's per-block quantized-cell sets);
  * per ``(chunk_a, chunk_b, block, eps, same)`` again under a distinct
    ``"bpair"`` tag — the bitmap-refined pair list from
    ``prune.refine_block_pairs`` with its killed-pair count, so warm
    queries skip the refinement pass along with the rest of prep.

Keying is *content-addressed through residency*: a chunk id's cell set
never changes while the id is live (splits retire the parent id and mint
new child ids), and the queried subset token — the query box intersected
with the chunk box, canonicalized to "full" when the chunk is entirely
covered — pins down exactly which coordinate slice the artifacts were
derived from. Invalidation therefore only has to follow the cache
life-cycle, and it does so through the same
:class:`repro_torch.core.cache_state.CacheState` listener hooks the device
backends use: ``on_drop`` and ``on_split`` fire point-wise from
eviction and split-remap, and ``reconcile`` prunes artifacts of chunks
that left residency in a wholesale policy round — artifacts can never
outlive their chunk. Simulated node failures
(``CacheCoordinator.fail_node``) need no extra wiring: a lost sole copy
leaves residency through the same hooks, and a chunk that survives via
a replica (or is re-admitted) is still resident, so its artifacts stay
valid — artifact keys name chunk content, never holder nodes.

The executors consult the cache through :class:`ChunkView` handles the
backends attach to join tasks (``repro_torch.backend.simulated.
SimulatedBackend.gather_join_tasks``); plain ndarray tasks pass through
uncached, so executor-level tests and custom callers are unaffected.
``hits``/``misses`` counters are surfaced per query as
``ExecutedQuery.artifact_hits``/``artifact_misses``.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Set,
                    Tuple)

import numpy as np

if TYPE_CHECKING:  # planning types only; no runtime import cycle
    from repro_torch.core.cache_state import CacheState
    from repro_torch.core.chunk import ChunkMeta
    from repro_torch.core.geometry import Box

# (chunk id, queried-subset token): () = the full chunk, otherwise the
# (lo, hi) corners of the query box intersected with the chunk box.
ChunkKey = Tuple[int, tuple]


def subset_token(chunk_box: Optional["Box"],
                 query_box: Optional["Box"]) -> Optional[tuple]:
    """Canonical queried-subset token of a chunk under a query box:
    ``()`` when the query covers the whole chunk (every covering query
    shares one token), the intersected ``(lo, hi)`` corners under
    partial coverage (the intersection pins down the coordinate slice
    exactly — cells live inside the chunk box), and ``None`` for
    disjoint or unknown geometry (uncacheable/unshareable). This is the
    sharing signature both the :class:`JoinArtifactCache` keys and the
    backends' cross-query MQO dedup
    (``repro_torch.backend.simulated.SimulatedBackend.execute_batch``) are
    built from."""
    if chunk_box is None or query_box is None:
        return None
    if query_box.contains_box(chunk_box):
        return ()
    inter = query_box.intersection(chunk_box)
    if inter is None:
        return None
    return (tuple(inter.lo), tuple(inter.hi))


@dataclasses.dataclass
class ChunkView:
    """One join-task side: a queried chunk's coordinate slice tagged
    with its artifact-cache key (``None`` disables caching — the slice
    came from a source the cache cannot address, e.g. a raw test array).
    Executors unwrap the coordinates with :func:`task_coords`."""

    key: Optional[ChunkKey]
    coords: np.ndarray


def task_coords(x) -> np.ndarray:
    """The raw (n, d) coordinate array of one join-task side, whether it
    is a bare ndarray (seed-shaped tasks) or a :class:`ChunkView`."""
    return x.coords if isinstance(x, ChunkView) else x


class _Artifacts:
    """Lazily-filled derived arrays of one (chunk, subset) slice."""

    __slots__ = ("sorted_coords", "padded", "bitmaps")

    def __init__(self):
        self.sorted_coords: Optional[np.ndarray] = None
        # sentinel value -> (d, N_padded) coordinate-major padded array
        # (one entry per join side: +sentinel for a, -sentinel for b).
        self.padded: Dict[int, np.ndarray] = {}
        # (block, scale) -> per-block hierarchical occupancy bitmaps
        # (list of (fine, coarse) quantized-cell arrays).
        self.bitmaps: Dict[Tuple[int, int], list] = {}


class JoinArtifactCache:
    """Memoized join-prep artifacts, invalidated in lockstep with cache
    residency (a ``CacheState`` listener alongside the device backends).

    ``max_subsets_per_chunk`` bounds memory for workloads whose query
    boxes slice one chunk many different ways: the least-recently-used
    subset's artifacts (and any pair lists referencing them) are
    evicted first.
    """

    def __init__(self, max_subsets_per_chunk: int = 8):
        self.max_subsets_per_chunk = max_subsets_per_chunk
        self._entries: Dict[ChunkKey, _Artifacts] = {}
        # ("pair", key_a, key_b, block, eps, same) -> (pairs, dense_total)
        # ("bpair", key_a, key_b, block, eps, same) -> (refined, killed)
        self._pairs: Dict[tuple, tuple] = {}
        # chunk id -> every key (entry or pair) derived from it, so one
        # residency event invalidates all dependent artifacts.
        self._by_chunk: Dict[int, Set[tuple]] = {}
        self._subset_order: Dict[int, List[tuple]] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    # ---------------------------------------------------------- keying

    def view(self, chunk_id: int, chunk_box: Optional["Box"],
             query_box: Optional["Box"], coords: np.ndarray) -> ChunkView:
        """Wrap a queried coordinate slice in its cache-addressable view.

        The subset token canonicalizes coverage: a chunk box entirely
        inside the query box yields the ``()`` (full-chunk) token — so
        every query that covers the whole chunk shares one artifact set
        — while partial coverage keys by the intersected box, which
        determines the slice content exactly (cells live inside the
        chunk box, so intersecting with the query box is equivalent to
        filtering by it). Unknown geometry degrades to an uncacheable
        passthrough view."""
        subset = subset_token(chunk_box, query_box)
        if subset is None:             # disjoint/unknown: nothing to cache
            return ChunkView(None, coords)
        return ChunkView((int(chunk_id), subset), coords)

    # --------------------------------------------------------- getters

    def _entry(self, view) -> Optional[_Artifacts]:
        """The artifact record behind a view (created on first touch,
        respecting the per-chunk subset cap), or ``None`` for
        uncacheable sides."""
        if not isinstance(view, ChunkView) or view.key is None:
            return None
        cid, subset = view.key
        order = self._subset_order.setdefault(cid, [])
        e = self._entries.get(view.key)
        if e is None:
            if subset not in order:
                order.append(subset)
                while len(order) > self.max_subsets_per_chunk:
                    self._evict_subset(cid, order.pop(0))
            e = self._entries[view.key] = _Artifacts()
            self._by_chunk.setdefault(cid, set()).add(view.key)
        elif order and order[-1] != subset:
            # LRU refresh: a hot subset touched on every query must not
            # be capacity-evicted ahead of cold one-off subsets.
            order.remove(subset)
            order.append(subset)
        return e

    def sorted_coords(self, view: ChunkView,
                      compute: Callable[[], np.ndarray]) -> np.ndarray:
        """The spatially sorted coordinate array of a view (memoized)."""
        e = self._entry(view)
        if e is None:
            return compute()
        if e.sorted_coords is None:
            self.misses += 1
            e.sorted_coords = compute()
        else:
            self.hits += 1
        return e.sorted_coords

    def padded(self, view: ChunkView, sentinel: int,
               compute: Callable[[], np.ndarray]) -> np.ndarray:
        """The sentinel-padded coordinate-major form of a view's sorted
        coordinates (memoized per sentinel sign, i.e. per join side)."""
        e = self._entry(view)
        if e is None:
            return compute()
        got = e.padded.get(sentinel)
        if got is None:
            self.misses += 1
            got = e.padded[sentinel] = compute()
        else:
            self.hits += 1
        return got

    def block_pairs(self, view_a, view_b, block: int, eps: int, same: bool,
                    compute: Callable[[], Tuple[np.ndarray, int]]
                    ) -> Tuple[np.ndarray, int]:
        """The ``(pairs, dense_total)`` pruned block-pair list for one
        task (memoized per chunk pair, block size, eps, and join mode;
        computed directly when either side is uncacheable)."""
        return self._pair_artifact("pair", view_a, view_b, block, eps,
                                   same, compute)

    def bitmaps(self, view: ChunkView, block: int, scale: int,
                compute: Callable[[], list]) -> list:
        """The hierarchical occupancy bitmaps of a view's sorted
        coordinates (memoized per block size and quantization scale) —
        the per-block ``(fine, coarse)`` quantized-cell sets the
        cell-exact prune stage intersects."""
        e = self._entry(view)
        if e is None:
            return compute()
        got = e.bitmaps.get((int(block), int(scale)))
        if got is None:
            self.misses += 1
            got = e.bitmaps[(int(block), int(scale))] = compute()
        else:
            self.hits += 1
        return got

    def refined_pairs(self, view_a, view_b, block: int, eps: int,
                      same: bool,
                      compute: Callable[[], Tuple[np.ndarray, int]]
                      ) -> Tuple[np.ndarray, int]:
        """The ``(refined_pairs, killed)`` bitmap-refined pair list for
        one task (memoized like :meth:`block_pairs` under a distinct
        ``"bpair"`` tag, so warm queries skip the bitmap intersection
        pass; invalidated through exactly the same residency hooks)."""
        return self._pair_artifact("bpair", view_a, view_b, block, eps,
                                   same, compute)

    def _pair_artifact(self, tag: str, view_a, view_b, block: int,
                       eps: int, same: bool,
                       compute: Callable[[], tuple]) -> tuple:
        """Shared memoization of per-chunk-pair artifacts (bbox pair
        lists and bitmap-refined pair lists), registered on both sides'
        chunks so either chunk's residency event invalidates them."""
        ka = view_a.key if isinstance(view_a, ChunkView) else None
        kb = view_b.key if isinstance(view_b, ChunkView) else None
        if ka is None or kb is None:
            return compute()
        key = (tag, ka, kb, int(block), int(eps), bool(same))
        got = self._pairs.get(key)
        if got is None:
            self.misses += 1
            got = self._pairs[key] = compute()
            self._by_chunk.setdefault(ka[0], set()).add(key)
            self._by_chunk.setdefault(kb[0], set()).add(key)
        else:
            self.hits += 1
        return got

    # --------------------------------------------------- introspection

    def chunk_ids(self) -> Set[int]:
        """Chunk ids that currently have at least one live artifact."""
        return {cid for cid in self._by_chunk if self.has_chunk(cid)}

    def has_chunk(self, chunk_id: int) -> bool:
        """Whether any artifact derived from this chunk is still live."""
        return any(
            (k in self._pairs) if k[0] in ("pair", "bpair")
            else (k in self._entries)
            for k in self._by_chunk.get(chunk_id, ()))

    def __len__(self) -> int:
        """Total live artifact records (entries + pair lists)."""
        return len(self._entries) + len(self._pairs)

    def audit(self) -> List[str]:
        """Internal-index consistency check (used by the cross-layer
        ``InvariantAuditor``): every live entry and pair list must be
        reachable from ``_by_chunk``, else a residency event could never
        invalidate it. Returns one description per violation."""
        out: List[str] = []
        indexed: Set[tuple] = set()
        for keys in self._by_chunk.values():
            indexed.update(keys)
        for key in self._entries:
            if key not in indexed:
                out.append(f"artifact entry {key!r} unreachable from "
                           f"the chunk index")
        for key in self._pairs:
            if key not in indexed:
                out.append(f"pair artifact {key!r} unreachable from "
                           f"the chunk index")
        return out

    # ---------------------------------------------------- invalidation

    def _evict_subset(self, cid: int, subset: tuple) -> None:
        """Capacity eviction of one (chunk, subset) slice: drop its
        entry and every pair list derived from it (pair keys registered
        on the partner chunk are popped here too; later discards are
        idempotent)."""
        old: tuple = (cid, subset)
        dropped = self._entries.pop(old, None) is not None
        keys = self._by_chunk.get(cid, set())
        stale = {k for k in keys
                 if k == old or (k[0] in ("pair", "bpair")
                                 and old in (k[1], k[2]))}
        for k in stale:
            keys.discard(k)
            if k[0] in ("pair", "bpair"):
                dropped += self._pairs.pop(k, None) is not None
        self.invalidations += int(dropped)

    def invalidate_chunk(self, chunk_id: int) -> int:
        """Drop every artifact derived from a chunk (entries and pair
        lists, both sides); returns the number of records dropped."""
        keys = self._by_chunk.pop(chunk_id, None)
        self._subset_order.pop(chunk_id, None)
        if not keys:
            return 0
        n = 0
        for k in keys:
            if k[0] in ("pair", "bpair"):
                n += self._pairs.pop(k, None) is not None
            else:
                n += self._entries.pop(k, None) is not None
        self.invalidations += n
        return n

    # ------------------------- residency listener (CacheState hooks) --

    def on_drop(self, chunk_id: int) -> None:
        """Eviction/placement dropped a chunk: its artifacts go with it."""
        self.invalidate_chunk(chunk_id)

    def on_split(self, parent_id: int, leaves: List["ChunkMeta"]) -> None:
        """A cached chunk split: the parent id is retired, so every
        artifact derived from it is stale by construction (children mint
        fresh ids and warm their own artifacts on next touch)."""
        self.invalidate_chunk(parent_id)

    def reconcile(self, state: "CacheState") -> None:
        """Post-round sync (the artifact twin of the device backends'
        reconcile): policy rounds reassign residency wholesale, so drop
        artifacts of every chunk no longer resident — the guarantee that
        artifacts never outlive their chunk."""
        for cid in list(self._by_chunk):
            if cid not in state.cached:
                self.invalidate_chunk(cid)

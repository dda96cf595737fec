"""Semantic cache reuse: a coverage index over resident chunk extents.

The paper routes every query through the catalog even when the requested
region is fully covered by chunks already resident in the cache. This
module adds the missing *semantic* layer (multi-query optimization a la
Michiardi et al., "Cache-based Multi-query Optimization", and the fast
containment tests over cached extents motivated by Krcal et al.'s
hierarchical bitmap indexing — both in PAPERS.md):

  * ``CoverageIndex`` — a two-level interval/R-tree structure over the
    bounding boxes of resident chunks (file-level bounding box on top,
    chunk boxes underneath), kept in sync by ``CacheState`` on
    admit/evict/split-remap.
  * ``QueryRewrite`` — a query region rewritten into (a) *covered slices*,
    sub-regions answerable from covering cached chunks that are sliced in
    place on their owning nodes, and (b) *residual* boxes that follow the
    existing catalog/scan path (``geometry.box_subtract`` decomposition).

Soundness note (why residuals compose per file): within one file the
evolving R-tree's leaf boxes are tight and pairwise disjoint, so a cached
chunk's box covers exactly that file's cells inside it — but cells of
*other* files may share the region. The coordinator therefore combines
box-level coverage from this index with a per-file cell-exact containment
test before it skips a raw-file scan (``CacheCoordinator``, reuse knob).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.core.chunk import ChunkMeta
from repro_torch.core.geometry import Box, enclosing, residual_boxes

__all__ = ["CoveredSlice", "QueryRewrite", "CoverageIndex"]


@dataclasses.dataclass(frozen=True)
class CoveredSlice:
    """A sub-region of a query answerable from one covering cached chunk.

    ``box`` is the intersection of the chunk's bounding box with the query
    region — the extent the owning node slices in place; shipped bytes for
    the join are charged only for the cells inside this slice.
    """

    chunk_id: int
    file_id: int
    box: Box                      # chunk box ∩ query box


@dataclasses.dataclass
class QueryRewrite:
    """A query region rewritten against the cache's covered extents.

    ``covered`` lists the cached-chunk slices that serve sub-regions of the
    query; ``residual`` is the query region minus the union of covering
    chunk boxes, as disjoint boxes that follow the normal catalog/scan
    path. ``fully_covered`` (empty residual) is the box-level
    all-from-cache fast path — the coordinator still confirms it with a
    cell-exact test per file before skipping scans.
    """

    query: Box
    covered: List[CoveredSlice]
    residual: List[Box]

    @property
    def fully_covered(self) -> bool:
        """True when the covering cached boxes leave no residual region."""
        return not self.residual

    def covered_chunk_ids(self) -> Set[int]:
        """Chunk ids of every covering cached chunk in the rewrite."""
        return {s.chunk_id for s in self.covered}


class CoverageIndex:
    """Two-level box index over the extents of resident chunks.

    Level 1 prunes by per-file bounding boxes (recomputed lazily after
    removals), level 2 tests the chunk boxes themselves — the hierarchical
    containment-test structure the reuse rewrite consults before a query's
    scan plan is built. Mutations mirror cache residency: ``add`` on
    admission, ``remove`` on eviction/drop, ``remap_split`` when the
    evolving R-tree retires a cached chunk into children
    (``CacheState`` drives all three).
    """

    def __init__(self) -> None:
        self._entries: Dict[int, ChunkMeta] = {}      # chunk_id -> meta
        self._by_file: Dict[int, Set[int]] = {}       # file_id -> chunk ids
        self._file_bb: Dict[int, Optional[Box]] = {}  # lazy file-level bbox

    # ------------------------------------------------------------ mutation

    def add(self, meta: ChunkMeta) -> None:
        """Index a newly resident chunk's bounding box."""
        self._entries[meta.chunk_id] = meta
        ids = self._by_file.setdefault(meta.file_id, set())
        ids.add(meta.chunk_id)
        bb = self._file_bb.get(meta.file_id)
        if bb is not None:
            self._file_bb[meta.file_id] = bb.union_bb(meta.box)
        elif len(ids) == 1:
            self._file_bb[meta.file_id] = meta.box
        # else: entry is dirty (None after a removal) — the next
        # ``_file_box`` call recomputes the union including this box.

    def remove(self, chunk_id: int) -> None:
        """Drop an evicted chunk; no-op when the id is not indexed."""
        meta = self._entries.pop(chunk_id, None)
        if meta is None:
            return
        ids = self._by_file.get(meta.file_id)
        if ids is not None:
            ids.discard(chunk_id)
            if not ids:
                del self._by_file[meta.file_id]
                self._file_bb.pop(meta.file_id, None)
            else:
                # Shrinking a union is not incremental: recompute lazily.
                self._file_bb[meta.file_id] = None

    def remap_split(self, parent_id: int,
                    children: Iterable[ChunkMeta]) -> None:
        """A cached chunk split: children inherit the parent's coverage."""
        if parent_id not in self._entries:
            return
        self.remove(parent_id)
        for cm in children:
            self.add(cm)

    # ------------------------------------------------------------- queries

    def __contains__(self, chunk_id: int) -> bool:
        return chunk_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def ids(self) -> Set[int]:
        """The indexed (resident) chunk-id set."""
        return set(self._entries)

    def box_of(self, chunk_id: int) -> Optional[Box]:
        """The indexed extent for ``chunk_id`` (``None`` if absent) —
        the invariant auditor compares it against chunk metadata."""
        meta = self._entries.get(chunk_id)
        return meta.box if meta is not None else None

    def _file_box(self, file_id: int) -> Optional[Box]:
        bb = self._file_bb.get(file_id)
        if bb is None and self._by_file.get(file_id):
            bb = enclosing(self._entries[cid].box
                           for cid in self._by_file[file_id])
            self._file_bb[file_id] = bb
        return bb

    def overlapping(self, box: Box) -> List[ChunkMeta]:
        """Resident chunks whose bounding box overlaps ``box`` (file-level
        prune, then chunk-level test), in chunk-id order."""
        out: List[ChunkMeta] = []
        for file_id, ids in self._by_file.items():
            bb = self._file_box(file_id)
            if bb is None or not bb.overlaps(box):
                continue
            out.extend(self._entries[cid] for cid in ids
                       if self._entries[cid].box.overlaps(box))
        out.sort(key=lambda m: m.chunk_id)
        return out

    def residual(self, box: Box) -> List[Box]:
        """``box`` minus the union of all resident chunk boxes."""
        return residual_boxes(box, (m.box for m in self.overlapping(box)))

    def rewrite(self, box: Box) -> QueryRewrite:
        """Rewrite a query region into covered slices + residual boxes."""
        covering = self.overlapping(box)
        covered = []
        for m in covering:
            inter = m.box.intersection(box)
            if inter is not None:
                covered.append(CoveredSlice(m.chunk_id, m.file_id, inter))
        residual = residual_boxes(box, (s.box for s in covered))
        return QueryRewrite(query=box, covered=covered, residual=residual)

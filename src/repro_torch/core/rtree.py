"""Evolving R-tree: query-driven chunking of a raw sparse array (§3.1, Alg. 1).

One tree per raw file. Leaves are the current chunks; internal nodes keep the
bounding boxes of retired (split) chunks and serve as the pruning index. The
tree only ever *refines*: a leaf splits into two leaves, chosen among the
query's faces that bisect the leaf's bounding box, minimizing the combined
hyper-volume of the two children's (cell-derived) bounding boxes.

Invariants (checked by ``validate()``):
  * the union of leaf ``cell_idx`` is exactly the file's cell set (cover);
  * leaf cell sets are pairwise disjoint (non-overlap);
  * every leaf box is the tight bounding box of its cells.

Split rule (Alg. 1 + §3.1 "When to split?"): a leaf overlapping query Q splits
iff  (n_cells >= min_cells)  OR  (no cell of the leaf lies inside Q).
A leaf whose box is contained in Q never splits (no query face bisects it, and
all of its cells are queried). Each split consumes one of the <= 2d bisecting
faces and children are never bisected by the same face again, so refinement
per query terminates after at most 2d levels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.clock import Clock, MONOTONIC

from repro_torch.core.chunk import Chunk
from repro_torch.core.geometry import Box, bounding_box, points_in_box, split_boundaries


@dataclasses.dataclass
class _Node:
    box: Box
    chunk: Optional[Chunk]                 # leaf iff chunk is not None
    children: Optional[List["_Node"]] = None


@dataclasses.dataclass
class RefineStats:
    """Counters for one Alg.-1 refinement pass (optimization-time cost).

    ``split_candidates`` / ``split_eval_s`` isolate the split-choice
    step (``_best_split``): how many candidate faces were scored and the
    wall-clock spent scoring them — the planner-side hot spot that the
    vectorized evaluation targets (``bench_opt_time`` reports both)."""

    splits: int = 0
    leaves_visited: int = 0
    cells_partitioned: int = 0
    split_candidates: int = 0
    split_eval_s: float = 0.0


class EvolvingRTree:
    """Per-file evolving R-tree over the file's cell coordinates."""

    def __init__(self, file_id: int, coords: np.ndarray, cell_bytes: int,
                 min_cells: int, next_chunk_id: Callable[[], int],
                 max_cells: Optional[int] = None,
                 clock: Optional[Clock] = None):
        """``max_cells`` (extension, DESIGN.md §7): chunks larger than this
        split at the median of their longest box side even when no query
        face bisects them (a fully-inside chunk otherwise never splits and
        can exceed one node's cache budget, making it un-placeable).
        ``None`` keeps Alg. 1 verbatim. ``clock`` is the injectable time
        source behind ``RefineStats.split_eval_s`` (default: the shared
        monotonic clock)."""
        if coords.ndim != 2:
            raise ValueError(f"coords must be (n, d), got {coords.shape}")
        self.file_id = file_id
        self.coords = coords
        self.cell_bytes = cell_bytes
        self.min_cells = min_cells
        self.max_cells = max_cells
        self.clock = clock if clock is not None else MONOTONIC
        self._next_id = next_chunk_id
        box = bounding_box(coords)
        if box is None:
            raise ValueError("cannot index an empty file")
        root_chunk = Chunk(self._next_id(), file_id, box,
                           np.arange(coords.shape[0], dtype=np.int64), cell_bytes)
        self._root = _Node(box=box, chunk=root_chunk)
        self._leaves: Dict[int, _Node] = {root_chunk.chunk_id: self._root}
        # chunk_id -> ids of the two children it split into (for remapping
        # historical cache/workload state through splits, §3.3).
        self.split_children: Dict[int, Tuple[int, int]] = {}

    # ------------------------------------------------------------------ API

    @property
    def root_box(self) -> Box:
        """Bounding box of the whole file (the tree's root)."""
        return self._root.box

    def leaves(self) -> List[Chunk]:
        """The current chunks (live leaves) of the file."""
        return [n.chunk for n in self._leaves.values()]  # type: ignore[misc]

    def n_leaves(self) -> int:
        """Number of live leaves (current chunk count)."""
        return len(self._leaves)

    def get_chunk(self, chunk_id: int) -> Chunk:
        """The live leaf chunk with this id (KeyError when retired)."""
        return self._leaves[chunk_id].chunk  # type: ignore[return-value]

    def descendants(self, chunk_id: int) -> List[int]:
        """Current leaf ids holding the cells of a (possibly split) chunk."""
        if chunk_id in self._leaves:
            return [chunk_id]
        out: List[int] = []
        stack = list(self.split_children.get(chunk_id, ()))
        while stack:
            cid = stack.pop()
            if cid in self._leaves:
                out.append(cid)
            else:
                stack.extend(self.split_children.get(cid, ()))
        return out

    def overlapping(self, query: Box) -> List[Chunk]:
        """Leaves whose bounding box overlaps ``query`` (pruned descent)."""
        out: List[Chunk] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if not node.box.overlaps(query):
                continue
            if node.chunk is not None:
                out.append(node.chunk)
            else:
                stack.extend(node.children or ())
        return out

    def refine(self, query: Box, stats: Optional[RefineStats] = None
               ) -> List[Chunk]:
        """Alg. 1 applied to every leaf overlapping ``query``; returns the
        post-refinement leaves that overlap the query."""
        st = stats if stats is not None else RefineStats()
        result: List[Chunk] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if not node.box.overlaps(query):
                continue
            if node.chunk is None:
                stack.extend(node.children or ())
                continue
            st.leaves_visited += 1
            self._refine_leaf(node, query, result, st)
        return result

    # ------------------------------------------------------------ internals

    def _refine_leaf(self, node: _Node, query: Box, result: List[Chunk],
                     st: RefineStats) -> None:
        chunk = node.chunk
        assert chunk is not None
        pts = self.coords[chunk.cell_idx]
        in_q = points_in_box(pts, query)
        has_queried_cell = bool(in_q.any())
        # Alg. 1 line 1: small chunk with a relevant cell -> keep as is.
        if chunk.n_cells < self.min_cells and has_queried_cell:
            result.append(chunk)
            return
        best = self._best_split(chunk, pts, query, st)
        if best is None and self.max_cells is not None and \
                chunk.n_cells > self.max_cells:
            best = self._median_split(pts)
        if best is None:
            # Box contained in the query (no bisecting face): every cell is
            # queried; nothing to carve off.
            if has_queried_cell:
                result.append(chunk)
            return
        lo_idx, hi_idx, lo_box, hi_box = best
        st.splits += 1
        st.cells_partitioned += chunk.n_cells
        children: List[_Node] = []
        child_ids: List[int] = []
        for idx, box in ((lo_idx, lo_box), (hi_idx, hi_box)):
            if box is None:
                continue
            c = Chunk(self._next_id(), self.file_id, box,
                      chunk.cell_idx[idx], self.cell_bytes)
            children.append(_Node(box=box, chunk=c))
            child_ids.append(c.chunk_id)
        # Retire the parent leaf.
        del self._leaves[chunk.chunk_id]
        node.chunk = None
        node.children = children
        self.split_children[chunk.chunk_id] = tuple(child_ids)  # type: ignore[assignment]
        for ch in children:
            self._leaves[ch.chunk.chunk_id] = ch  # type: ignore[union-attr]
            if ch.box.overlaps(query):
                self._refine_leaf(ch, query, result, st)

    def _best_split(self, chunk: Chunk, pts: np.ndarray, query: Box,
                    st: Optional[RefineStats] = None):
        """Enumerate query faces bisecting the chunk box; minimize combined
        child hyper-volume (Alg. 1 lines 2-9). All candidate faces are
        scored in ONE vectorized masked min/max pass over the cells
        (child boxes and volumes for every face at once) instead of two
        ``bounding_box`` scans per face; only the winning face's masks
        and boxes are materialized. First strict minimum wins, matching
        the original candidate-order tie-breaking."""
        candidates = split_boundaries(query, chunk.box)
        if not candidates:
            return None
        t0 = self.clock.now()
        dims = np.fromiter((d for d, _ in candidates), dtype=np.int64)
        cuts = np.fromiter((c for _, c in candidates), dtype=np.int64)
        lo_masks = pts[:, dims] <= cuts                        # (n, K)
        m = lo_masks[:, :, None]                               # (n, K, 1)
        p3 = pts[:, None, :].astype(np.int64, copy=False)      # (n, 1, d)
        big = np.iinfo(np.int64).max
        small = np.iinfo(np.int64).min
        lo_min = np.where(m, p3, big).min(axis=0)              # (K, d)
        lo_max = np.where(m, p3, small).max(axis=0)
        hi_min = np.where(~m, p3, big).min(axis=0)
        hi_max = np.where(~m, p3, small).max(axis=0)
        n_lo = lo_masks.sum(axis=0)                            # (K,)
        n = pts.shape[0]
        best_k = 0
        best_vol = None
        for k in range(len(candidates)):
            # Volumes in python ints (unbounded), exactly as Box.volume();
            # an empty child contributes 0, as in the bounding_box path.
            vol = 0
            if n_lo[k] > 0:
                v = 1
                for s in lo_max[k] - lo_min[k] + 1:
                    v *= int(s)
                vol += v
            if n_lo[k] < n:
                v = 1
                for s in hi_max[k] - hi_min[k] + 1:
                    v *= int(s)
                vol += v
            if best_vol is None or vol < best_vol:
                best_vol = vol
                best_k = k
        lo_mask = lo_masks[:, best_k]
        lo_box = (Box(tuple(int(x) for x in lo_min[best_k]),
                      tuple(int(x) for x in lo_max[best_k]))
                  if n_lo[best_k] > 0 else None)
        hi_box = (Box(tuple(int(x) for x in hi_min[best_k]),
                      tuple(int(x) for x in hi_max[best_k]))
                  if n_lo[best_k] < n else None)
        if st is not None:
            st.split_candidates += len(candidates)
            st.split_eval_s += self.clock.now() - t0
        # A degenerate cut (all cells on one side -> one box None) still
        # makes progress: the surviving child's box is strictly tighter
        # (the cut bisected the parent box, carving off empty margin).
        return (np.nonzero(lo_mask)[0], np.nonzero(~lo_mask)[0],
                lo_box, hi_box)

    def _median_split(self, pts: np.ndarray):
        """Median cut along the longest box side with both sides non-empty
        (used only for over-budget chunks; see ``max_cells``)."""
        spans = pts.max(axis=0) - pts.min(axis=0)
        for dim in np.argsort(spans)[::-1]:
            vals = pts[:, dim]
            cut = int(np.median(vals))
            lo_mask = vals <= cut
            if lo_mask.all() or not lo_mask.any():
                cut = int(vals.min())
                lo_mask = vals <= cut
                if lo_mask.all():
                    continue
            lo_box = bounding_box(pts[lo_mask])
            hi_box = bounding_box(pts[~lo_mask])
            return (np.nonzero(lo_mask)[0], np.nonzero(~lo_mask)[0],
                    lo_box, hi_box)
        return None

    # ------------------------------------------------------------ validation

    def validate(self) -> None:
        """Check the cover / non-overlap / tight-box invariants."""
        seen = np.zeros(self.coords.shape[0], dtype=np.int64)
        for leaf in self._leaves.values():
            c = leaf.chunk
            assert c is not None
            seen[c.cell_idx] += 1
            bb = bounding_box(self.coords[c.cell_idx])
            assert bb is not None and bb == c.box, (
                f"leaf {c.chunk_id}: box {c.box} not tight (expected {bb})")
        assert (seen == 1).all(), "leaves do not partition the file's cells"

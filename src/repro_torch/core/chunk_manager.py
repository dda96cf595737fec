"""Layer 1 of the planning engine: chunk lifecycle and size metadata.

The ``ChunkManager`` owns everything about *what the cache units are*:
the per-file evolving R-trees (Alg. 1), the global chunk-id space, the
chunk -> file mapping, split remapping, and the chunk/file size tables the
eviction and placement layers consume. It never decides *what to keep* or
*where to put it* — that is the policy layer (``repro_torch.core.policies``)
operating on ``repro_torch.core.cache_state.CacheState``.

Two granularities are supported:

  * ``chunk`` — cells are grouped by the query-driven R-tree refinement;
  * ``file``  — every raw file is a single-chunk unit (the paper's
    ``file_lru`` baseline). File units draw ids from the same positive
    id space as tree chunks, which removes the seed's negative-chunk-id
    encoding: downstream layers treat both granularities uniformly.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:  # duck-typed at runtime to avoid a package cycle
    from repro_torch.arrayio.catalog import Catalog, FileReader

import numpy as np

from repro_torch.core.chunk import ChunkMeta, FileMeta
from repro_torch.core.rtree import EvolvingRTree
from repro_torch.obs.clock import Clock, MONOTONIC


class ChunkManager:
    """R-tree lifecycle, split remapping, and size tables."""

    def __init__(self, catalog: "Catalog", reader: "FileReader",
                 min_cells: int, node_budget_bytes: int,
                 clock: Optional[Clock] = None):
        self.catalog = catalog
        self.reader = reader
        self.min_cells = min_cells
        self.node_budget = node_budget_bytes
        # Injectable time source threaded into every tree's refinement
        # timing (RefineStats.split_eval_s) — repro_torch.obs satellite.
        self.clock = clock if clock is not None else MONOTONIC
        self._chunk_counter = 0
        self.trees: Dict[int, EvolvingRTree] = {}
        self.chunk_file: Dict[int, int] = {}       # chunk_id -> file_id
        self._file_units: Dict[int, ChunkMeta] = {}  # file_id -> unit meta

    # ------------------------------------------------------------- id space

    def next_chunk_id(self) -> int:
        """Allocate the next globally-unique (positive) chunk id."""
        self._chunk_counter += 1
        return self._chunk_counter

    # --------------------------------------------------- chunk granularity

    def tree(self, meta: FileMeta) -> EvolvingRTree:
        """The file's evolving R-tree, built (one full read) on first touch."""
        tree = self.trees.get(meta.file_id)
        if tree is None:
            coords, _ = self.reader.read(meta.file_id)
            # Cap chunk size at a quarter of one node's budget so placement
            # can always pack what eviction retains (rtree.py max_cells).
            max_cells = max(2 * self.min_cells,
                            self.node_budget // (4 * meta.cell_bytes))
            tree = EvolvingRTree(meta.file_id, coords, meta.cell_bytes,
                                 self.min_cells, self.next_chunk_id,
                                 max_cells=max_cells, clock=self.clock)
            self.trees[meta.file_id] = tree
            self.chunk_file[tree.leaves()[0].chunk_id] = meta.file_id
        return tree

    def descendants(self, chunk_id: int) -> List[int]:
        """Current leaf ids holding the cells of a (possibly split) chunk."""
        fid = self.chunk_file.get(chunk_id)
        if fid is None:
            return []
        if fid in self.trees:
            return self.trees[fid].descendants(chunk_id)
        return [chunk_id]          # file units never split

    def remap_after_splits(self, tree: EvolvingRTree, cache_state,
                           eviction_policy) -> None:
        """Propagate split chunk ids through cache bookkeeping: children
        inherit residency, location, and coverage-index membership from the
        retired parent, and the eviction policy's recency/frequency
        structures are renamed (§3.3 — historical state survives Alg. 1
        refinement)."""
        for cid, children in list(tree.split_children.items()):
            for ch in children:
                self.chunk_file.setdefault(ch, tree.file_id)
            if cid in cache_state.cached:
                cache_state.remap_split(
                    cid, [ChunkMeta.of(tree.get_chunk(d))
                          for d in tree.descendants(cid)])
            if eviction_policy.tracks(cid):
                kids = [(ch, tree.get_chunk(ch).nbytes)
                        for ch in tree.descendants(cid)]
                eviction_policy.on_split(cid, kids)

    # ---------------------------------------------------- file granularity

    def file_unit(self, meta: FileMeta) -> ChunkMeta:
        """The whole file as a single-chunk cache/join unit."""
        unit = self._file_units.get(meta.file_id)
        if unit is None:
            unit = ChunkMeta(chunk_id=self.next_chunk_id(),
                             file_id=meta.file_id, box=meta.box,
                             n_cells=meta.n_cells,
                             nbytes=meta.n_cells * meta.cell_bytes)
            self._file_units[meta.file_id] = unit
            self.chunk_file[unit.chunk_id] = meta.file_id
        return unit

    # ------------------------------------------------------------- lookups

    def cell_indices(self, chunk_id: int, file_id: int
                     ) -> Optional[np.ndarray]:
        """Indices into the file's cell table for a unit, or ``None``
        meaning the whole file (file-granularity units). A chunk retired
        by a later split in the same admission batch resolves to its
        descendants' cells (splits partition the parent exactly)."""
        unit = self._file_units.get(file_id)
        if unit is not None and unit.chunk_id == chunk_id:
            return None
        tree = self.trees[file_id]
        ds = tree.descendants(chunk_id)
        if ds == [chunk_id]:
            return tree.get_chunk(chunk_id).cell_idx
        return np.concatenate([tree.get_chunk(d).cell_idx for d in ds])

    def chunk_coords(self, chunk_id: int, file_id: int) -> np.ndarray:
        """Cell coordinates of a unit — tree leaf or whole file."""
        idx = self.cell_indices(chunk_id, file_id)
        if idx is None:
            coords, _ = self.reader.read(file_id)
            return coords
        return self.trees[file_id].coords[idx]

    def current_units(self, cm: ChunkMeta) -> List[ChunkMeta]:
        """A queried unit remapped onto the present leaf set. Identity for
        live leaves and file units; a chunk retired by a later split (which
        only happens under batched admission) expands to its descendants."""
        unit = self._file_units.get(cm.file_id)
        if unit is not None and unit.chunk_id == cm.chunk_id:
            return [cm]
        tree = self.trees.get(cm.file_id)
        if tree is None:
            return [cm]
        ds = tree.descendants(cm.chunk_id)
        if ds == [cm.chunk_id]:
            return [cm]
        return [ChunkMeta.of(tree.get_chunk(d)) for d in ds]

    def meta_of(self, chunk_id: int) -> Optional[ChunkMeta]:
        """Metadata for a *live* unit (tree leaf or file unit), or ``None``
        for retired/unknown ids — the coverage-index sync's resolver."""
        fid = self.chunk_file.get(chunk_id)
        if fid is None:
            return None
        unit = self._file_units.get(fid)
        if unit is not None and unit.chunk_id == chunk_id:
            return unit
        tree = self.trees.get(fid)
        if tree is None:
            return None
        try:
            return ChunkMeta.of(tree.get_chunk(chunk_id))
        except KeyError:
            return None

    def home_node(self, chunk_id: int) -> int:
        """The node storing the raw file a unit belongs to."""
        return self.catalog.by_id(self.chunk_file[chunk_id]).node

    def size_tables(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(chunk_id -> bytes, file_id -> raw scan bytes) over all live
        units: R-tree leaves plus file-granularity units."""
        chunk_bytes: Dict[int, int] = {}
        for tree in self.trees.values():
            for c in tree.leaves():
                chunk_bytes[c.chunk_id] = c.nbytes
        for unit in self._file_units.values():
            chunk_bytes[unit.chunk_id] = unit.nbytes
        file_bytes = {f.file_id: f.file_bytes for f in self.catalog.files}
        return chunk_bytes, file_bytes

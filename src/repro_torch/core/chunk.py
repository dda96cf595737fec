"""Chunk and raw-file metadata objects shared by the caching framework.

A *chunk* (§3.1) is a set of cells from exactly one raw file, with a bounding
box derived from the cells assigned to it. Chunks partition each file's cells
(cover + non-overlap invariant of the evolving R-tree). The coordinator keeps
chunk *metadata* (box, counts, sizes) persistently; chunk *data* lives in node
caches and is lost on eviction — it must be recreated by a full raw-file scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.geometry import Box


@dataclasses.dataclass
class FileMeta:
    """Catalog entry for one raw file (§2.1, Figure 1)."""

    file_id: int
    node: int                      # home node storing the raw file
    path: str                      # identifier into the arrayio layer
    fmt: str                       # 'csv' | 'fits' | 'hdf5'
    box: Box                       # file-level bounding box (from the catalog)
    n_cells: int
    file_bytes: int                # raw on-disk size — cost of one full scan
    cell_bytes: int                # in-memory size of one extracted cell


@dataclasses.dataclass
class Chunk:
    """A leaf of the evolving R-tree.

    ``cell_idx`` indexes into the owning file's coordinate table. ``box`` is
    always the tight bounding box of those cells. ``chunk_id`` is globally
    unique and stable until the chunk is split (split children get new ids;
    the parent id is retired and remapped via ``EvolvingRTree.descendants``).
    """

    chunk_id: int
    file_id: int
    box: Box
    cell_idx: np.ndarray           # (n,) int64 indices into file cell table
    cell_bytes: int                # per-cell in-memory size

    @property
    def n_cells(self) -> int:
        """Number of cells assigned to this chunk."""
        return int(self.cell_idx.shape[0])

    @property
    def nbytes(self) -> int:
        """In-memory size of the chunk's extracted cells (cache cost)."""
        return self.n_cells * self.cell_bytes

    def __hash__(self) -> int:
        return hash(self.chunk_id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Chunk) and other.chunk_id == self.chunk_id

    def __repr__(self) -> str:
        return (f"Chunk(id={self.chunk_id}, file={self.file_id}, "
                f"n={self.n_cells}, box={self.box.lo}..{self.box.hi})")


@dataclasses.dataclass(frozen=True)
class ChunkMeta:
    """Coordinator-side view of a chunk — no cell data, metadata only."""

    chunk_id: int
    file_id: int
    box: Box
    n_cells: int
    nbytes: int

    @staticmethod
    def of(c: Chunk) -> "ChunkMeta":
        """Project a data-bearing ``Chunk`` to its metadata view."""
        return ChunkMeta(c.chunk_id, c.file_id, c.box, c.n_cells, c.nbytes)

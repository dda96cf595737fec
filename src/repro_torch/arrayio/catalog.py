"""System catalog: raw files, their home nodes, and bounding boxes (§2.1).

The catalog is the coordinator-resident metadata store: active servers, array
schema, file -> node assignment, and the per-file bounding box B(f_{i,j})
recorded at acquisition time (§3 Problem setting). It never holds cell data.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.arrayio import formats
from repro_torch.arrayio.generator import GeneratedFile
from repro_torch.core.chunk import FileMeta
from repro_torch.core.geometry import Box, enclosing
from repro_torch.faults.errors import ScanError


@dataclasses.dataclass
class Catalog:
    """Coordinator-resident file metadata: one FileMeta per raw file
    plus the array schema (dimension and attribute counts)."""

    files: List[FileMeta]
    ndim: int
    nattr: int

    @property
    def domain(self) -> Box:
        """The enclosing box of every file's bounding box."""
        box = enclosing(f.box for f in self.files)
        assert box is not None
        return box

    def files_overlapping(self, query: Box) -> List[FileMeta]:
        """Files whose bounding box overlaps ``query``."""
        return [f for f in self.files if f.box.overlaps(query)]

    def by_id(self, file_id: int) -> FileMeta:
        """The FileMeta of ``file_id``."""
        return self.files[file_id]


def build_catalog(generated: Sequence[GeneratedFile],
                  root: str,
                  fmt: str,
                  n_nodes: int,
                  in_memory: bool = True) -> Tuple[Catalog, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """Materialize generated files in ``fmt`` under ``root`` (round-robin over
    nodes, as in Figure 1) and build the catalog.

    Returns the catalog plus an id -> (coords, attrs) map. With
    ``in_memory=True`` the bytes are still written (sizes are real) but reads
    during query processing are served from memory while the *cost model*
    charges the disk scan — the algorithmic quantities stay exact without
    re-decoding gigabytes in CI. ``in_memory=False`` re-reads through the
    format decoder every time (used by the arrayio tests and the full-scale
    benchmark mode).
    """
    os.makedirs(root, exist_ok=True)
    metas: List[FileMeta] = []
    data: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    ndim = generated[0].coords.shape[1]
    nattr = generated[0].attrs.shape[1]
    for i, g in enumerate(generated):
        path = os.path.join(root, f"file_{i:05d}.{fmt}")
        nbytes = formats.write_array_file(path, fmt, g.coords, g.attrs)
        cell_bytes = ndim * 8 + nattr * 4
        metas.append(FileMeta(file_id=i, node=i % n_nodes, path=path, fmt=fmt,
                              box=g.box, n_cells=g.coords.shape[0],
                              file_bytes=nbytes, cell_bytes=cell_bytes))
        if in_memory:
            data[i] = (g.coords, g.attrs)
    catalog = Catalog(files=metas, ndim=ndim, nattr=nattr)
    return catalog, data


class FileReader:
    """Read cells of a raw file — from memory (cost-modeled) or from disk
    through the real format decoder."""

    def __init__(self, catalog: Catalog,
                 data: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None):
        self.catalog = catalog
        self._data = data or {}

    def read(self, file_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Cells of ``file_id`` as ``(coords, attrs)``, memoized.

        A missing or truncated file (or a decoder failure) raises a
        typed :class:`~repro_torch.faults.errors.ScanError` naming the file —
        the planner annotates it with the queried box and routes it
        through the retry/degrade path instead of letting a bare
        ``OSError``/numpy exception escape mid-scan."""
        if file_id in self._data:
            return self._data[file_id]
        meta = self.catalog.by_id(file_id)
        try:
            coords, attrs = formats.read_array_file(meta.path, meta.fmt)
        except ScanError:
            raise
        except (OSError, ValueError, EOFError, IndexError, KeyError) as e:
            raise ScanError(file_id, meta.path, cause=e) from e
        self._data[file_id] = (coords, attrs)
        return coords, attrs

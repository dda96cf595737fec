"""Axis-aligned box geometry over integer array domains.

The paper's arrays have dimensions represented by continuous integer ranges
[1, N] (§2.1). A ``Box`` is a closed integer hyper-rectangle ``[lo_k, hi_k]``
per dimension. Bounding boxes of chunks are always derived from the cells
assigned to the chunk (§3.1 "How to split?"), never from the query geometry.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Box:
    """Closed integer hyper-rectangle: lo[k] <= x[k] <= hi[k] for all k."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.lo) != len(self.hi):
            raise ValueError(f"rank mismatch: {self.lo} vs {self.hi}")
        if any(l > h for l, h in zip(self.lo, self.hi)):
            raise ValueError(f"empty box: lo={self.lo} hi={self.hi}")

    @property
    def ndim(self) -> int:
        """Dimensionality of the array domain (§2.1: d dimensions)."""
        return len(self.lo)

    def volume(self) -> int:
        """Hyper-volume as number of integer cells covered."""
        v = 1
        for l, h in zip(self.lo, self.hi):
            v *= h - l + 1
        return v

    def side(self, k: int) -> int:
        """Extent (cell count) along dimension ``k``."""
        return self.hi[k] - self.lo[k] + 1

    def contains_point(self, p: Sequence[int]) -> bool:
        """Closed-interval membership test for one coordinate."""
        return all(l <= x <= h for l, x, h in zip(self.lo, p, self.hi))

    def contains_box(self, other: "Box") -> bool:
        """True when ``other`` lies entirely inside this box."""
        return all(sl <= ol and oh <= sh for sl, sh, ol, oh in
                   zip(self.lo, self.hi, other.lo, other.hi))

    def overlaps(self, other: "Box") -> bool:
        """True when the boxes share at least one integer cell (closed
        intervals: touching faces count as overlap)."""
        return all(sl <= oh and ol <= sh for sl, sh, ol, oh in
                   zip(self.lo, self.hi, other.lo, other.hi))

    def intersection(self, other: "Box") -> Optional["Box"]:
        """The shared sub-box, or ``None`` when the boxes are disjoint."""
        lo = tuple(max(a, b) for a, b in zip(self.lo, other.lo))
        hi = tuple(min(a, b) for a, b in zip(self.hi, other.hi))
        if any(l > h for l, h in zip(lo, hi)):
            return None
        return Box(lo, hi)

    def union_bb(self, other: "Box") -> "Box":
        """Smallest box enclosing both boxes (R-tree node union)."""
        return Box(tuple(min(a, b) for a, b in zip(self.lo, other.lo)),
                   tuple(max(a, b) for a, b in zip(self.hi, other.hi)))

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) corners as int64 numpy vectors for bulk point tests."""
        return np.asarray(self.lo, dtype=np.int64), np.asarray(self.hi, dtype=np.int64)


def bounding_box(coords: np.ndarray) -> Optional[Box]:
    """Tightest Box around integer coordinates ``coords`` of shape (n, d).

    Returns None for an empty cell set — the paper derives chunk boxes only
    from assigned cells, so a cell-less side of a split simply vanishes.
    """
    if coords.size == 0:
        return None
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    return Box(tuple(int(x) for x in lo), tuple(int(x) for x in hi))


def points_in_box(coords: np.ndarray, box: Box) -> np.ndarray:
    """Boolean mask (n,) of which coords lie inside ``box``."""
    if coords.size == 0:
        return np.zeros((0,), dtype=bool)
    lo, hi = box.as_arrays()
    return np.logical_and(coords >= lo, coords <= hi).all(axis=1)


def expand(box: Box, radius: int, domain: Optional[Box] = None) -> Box:
    """Minkowski-expand a box by ``radius`` in every dimension (for L^inf /
    L^1 similarity-join neighborhoods), clipped to ``domain`` if given."""
    lo = tuple(l - radius for l in box.lo)
    hi = tuple(h + radius for h in box.hi)
    if domain is not None:
        lo = tuple(max(a, b) for a, b in zip(lo, domain.lo))
        hi = tuple(min(a, b) for a, b in zip(hi, domain.hi))
    return Box(lo, hi)


def enclosing(boxes: Iterable[Box]) -> Optional[Box]:
    """Smallest box enclosing every box in ``boxes`` (``None`` if empty)."""
    out: Optional[Box] = None
    for b in boxes:
        out = b if out is None else out.union_bb(b)
    return out


def box_subtract(a: Box, b: Box) -> "list[Box]":
    """Decompose ``a \\ b`` into disjoint residual boxes (slab decomposition).

    Peels one axis-aligned slab per face of ``b`` that cuts through ``a``,
    producing at most ``2 * ndim`` pairwise-disjoint boxes whose union is
    exactly the cells of ``a`` outside ``b``. Returns ``[a]`` when the boxes
    do not overlap and ``[]`` when ``b`` fully covers ``a`` (exact fit
    included — boxes are closed, so touching-but-not-overlapping neighbors
    share no cells and subtraction leaves ``a`` intact). This is the
    residual-region primitive of the semantic cache-reuse rewrite
    (multi-query optimization a la Michiardi et al., PAPERS.md).
    """
    inter = a.intersection(b)
    if inter is None:
        return [a]
    out: list[Box] = []
    lo = list(a.lo)
    hi = list(a.hi)
    for k in range(a.ndim):
        if lo[k] < inter.lo[k]:
            slab_hi = list(hi)
            slab_hi[k] = inter.lo[k] - 1
            out.append(Box(tuple(lo), tuple(slab_hi)))
        if inter.hi[k] < hi[k]:
            slab_lo = list(lo)
            slab_lo[k] = inter.hi[k] + 1
            out.append(Box(tuple(slab_lo), tuple(hi)))
        # Shrink the working box to b's extent along k; remaining slabs are
        # carved from dimensions > k only, keeping the pieces disjoint.
        lo[k], hi[k] = inter.lo[k], inter.hi[k]
    return out


def residual_boxes(box: Box, covers: Iterable[Box]) -> "list[Box]":
    """The part of ``box`` not covered by any box in ``covers``, as a list
    of disjoint boxes.

    Iteratively subtracts each cover from the current residual set
    (worst-case output grows with cover count; cached-extent cover sets are
    small — a query overlaps few resident chunks). An empty result means
    ``covers`` fully covers ``box``: the fully-answerable-from-cache test
    of the semantic reuse layer."""
    residual = [box]
    for cover in covers:
        if not residual:
            return residual
        residual = [piece for r in residual for piece in box_subtract(r, cover)]
    return residual


def split_boundaries(query: Box, bb: Box) -> list:
    """Candidate split boundaries per Alg. 1: the faces of the query subarray
    that pass strictly through ``bb``.

    Each boundary is ``(dim, cut)`` meaning cells with ``coord[dim] <= cut``
    go to the low side. A query face q.lo[k] maps to cut = q.lo[k]-1 (cells
    strictly below the query go low); a face q.hi[k] maps to cut = q.hi[k].
    Only faces with bb.lo[k] <= cut < bb.hi[k] actually bisect the box.
    """
    out = []
    for k in range(query.ndim):
        for cut in (query.lo[k] - 1, query.hi[k]):
            if bb.lo[k] <= cut < bb.hi[k]:
                out.append((k, cut))
    return out

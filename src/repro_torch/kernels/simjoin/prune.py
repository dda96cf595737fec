"""Host-side block pruning for the block-sparse simjoin kernel.

Pure-numpy preprocessing that turns a coordinate set into the inputs the
``simjoin_pruned_block_counts`` kernel consumes:

  1. ``spatial_sort`` orders cells along the longest dimension of their
     bounding box (lexicographic tie-break over the remaining
     dimensions) so consecutive 128-wide kernel blocks are spatially
     coherent (tight per-block boxes);
  2. ``block_bounds`` computes those per-block bounding boxes (real
     cells only — sentinel padding never enters a box);
  3. ``build_block_pairs`` keeps only the block pairs whose minimal L1
     box distance is ``<= eps`` — a sound prune because the minimal box
     distance lower-bounds the distance of every cell pair inside the
     two blocks (property-tested in ``test_hypothesis_properties``);
  4. ``pad_pairs``/``padded_pair_len`` pad surviving pair lists to a
     power-of-two bucket length so shape-bucketed batch dispatch does
     not retrace per distinct pair count.

A second, *cell-exact* prune stage refines the bbox-surviving pairs
(after Krčál et al.'s hierarchical bitmap indexing for
range/membership queries on multidimensional arrays):

  5. ``build_bitmaps`` derives a small hierarchical occupancy bitmap
     sidecar per block — the set of eps-quantized grid cells its real
     cells occupy (fine level, step ``bitmap_scale(eps)``) plus a
     coarse summary level (``BITMAP_COARSE``× wider cells);
  6. ``refine_block_pairs`` intersects each surviving bbox pair's
     dilated occupancy sets: a pair stays live only if some occupied
     fine cell of one block lies within the eps-dilation of an occupied
     fine cell of the other (coarse level first — most far pairs die on
     the cheap summary). Killing a pair is sound because every real
     cell lies inside its quantized grid cell, whose minimal box
     distance lower-bounds every contained cell pair's distance — the
     same argument as the bbox prune, applied per occupied cell instead
     of per whole block, so non-convex/stringy blocks whose boxes
     overlap empty space stop keeping pairs alive.

The count is invariant under the reordering: the join is a sum over
unordered cell pairs, and self-join dedup compares *positions in the
sorted order*, which still counts each unordered pair exactly once.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: Coarse summary factor of the hierarchical bitmap: one coarse cell
#: covers ``BITMAP_COARSE`` fine cells per dimension, so the summary
#: level holds far fewer occupied cells and kills most far pairs before
#: the fine-level intersection runs.
BITMAP_COARSE = 8

#: Fine-level quantization: the grid step is ``~eps / BITMAP_REFINE``.
#: A block holds at most 128 cells, so the occupied-cell set is bounded
#: regardless of the step — a fine step costs nothing extra here and
#: buys prune precision (on the GEO bench, eps/64 recovers 38 of the 46
#: pairs an exact min-distance test would kill vs 18 at eps/8).
BITMAP_REFINE = 64


def spatial_sort(coords: np.ndarray) -> np.ndarray:
    """Order (n, d) integer cell coordinates along the longest dimension
    of their bounding box, breaking ties lexicographically over the
    remaining dimensions (in ascending dimension order; stable), so
    equal-key runs stay spatially compact and per-block boxes come out
    tighter. A 0/1-cell set is returned unchanged; the pair count is
    invariant under any reordering (see the module docstring)."""
    if coords.shape[0] <= 1:
        return coords
    spans = coords.max(axis=0) - coords.min(axis=0)
    dim = int(np.argmax(spans))
    rest = [k for k in range(coords.shape[1]) if k != dim]
    # np.lexsort sorts by its LAST key first: primary = the longest
    # dimension, then the remaining dimensions most-significant first.
    keys = tuple(coords[:, k] for k in reversed(rest)) + (coords[:, dim],)
    return coords[np.lexsort(keys)]


def block_bounds(coords: np.ndarray, block: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Tight per-block bounding boxes of (n, d) coords split into
    ``block``-sized runs (last run possibly partial): (lo, hi) int64
    arrays of shape (ceil(n/block), d). Boxes come from real cells only,
    so downstream sentinel padding cannot loosen them."""
    if coords.shape[0] == 0:
        return (np.zeros((0, coords.shape[1]), np.int64),
                np.zeros((0, coords.shape[1]), np.int64))
    idx = np.arange(0, coords.shape[0], block)
    c = coords.astype(np.int64, copy=False)
    return (np.minimum.reduceat(c, idx, axis=0),
            np.maximum.reduceat(c, idx, axis=0))


def min_l1_box_dist(lo_a: np.ndarray, hi_a: np.ndarray,
                    lo_b: np.ndarray, hi_b: np.ndarray) -> np.ndarray:
    """(A, B) matrix of minimal L1 distances between two box sets given
    as (A, d)/(B, d) lo/hi corners: per dimension the gap between the
    closed intervals (zero when they overlap), summed over dimensions.
    Lower-bounds the L1 distance of any cell pair drawn from the two
    boxes — the soundness condition of the block prune."""
    gap = (np.maximum(lo_a[:, None, :] - hi_b[None, :, :], 0)
           + np.maximum(lo_b[None, :, :] - hi_a[:, None, :], 0))
    return gap.sum(axis=-1)


def build_block_pairs(a_sorted: np.ndarray, b_sorted: np.ndarray,
                      block: int, eps: int, same: bool
                      ) -> Tuple[np.ndarray, int]:
    """The live block-pair list for two spatially sorted coordinate
    sets: rows ``(block_i, block_j, 1)`` (int32) for every block pair
    whose minimal L1 box distance is ``<= eps``. Self-join mode keeps
    only ``i <= j`` pairs — every cell pair of an ``i > j`` block pair
    is eliminated by the kernel's ``i < j`` dedup mask anyway.

    Returns ``(pairs, dense_total)`` where ``dense_total`` is the number
    of block pairs the dense kernel would evaluate (the denominator of
    the ``block_pairs_evaluated / block_pairs_total`` counters)."""
    lo_a, hi_a = block_bounds(a_sorted, block)
    lo_b, hi_b = block_bounds(b_sorted, block)
    keep = min_l1_box_dist(lo_a, hi_a, lo_b, hi_b) <= eps
    if same:
        bi = np.arange(keep.shape[0])
        keep &= bi[:, None] <= bi[None, :]
    pi, pj = np.nonzero(keep)
    pairs = np.stack([pi, pj, np.ones_like(pi)], axis=1).astype(np.int32)
    return pairs, int(keep.size)


def padded_pair_len(n_pairs: int) -> int:
    """Bucket granularity for pair lists: the next power of two (at
    least 8), so batched dispatch sees a handful of pair-list shapes
    instead of one per distinct live-pair count."""
    n = max(int(n_pairs), 1)
    return max(8, 1 << (n - 1).bit_length())


def bitmap_scale(eps: int) -> int:
    """The fine-level quantization step of the occupancy bitmaps for an
    eps threshold: ``~eps / BITMAP_REFINE`` (at least 1). At small eps
    (``< BITMAP_REFINE``, including the ``eps = 0`` edge) the step is 1
    and the fine level holds the exact cell coordinates — the dilation
    test degenerates to an exact point membership test."""
    return max(1, -(-int(eps) // BITMAP_REFINE))


def build_bitmaps(coords: np.ndarray, block: int, scale: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Hierarchical occupancy bitmap sidecars of (n, d) sorted coords
    split into ``block``-sized runs: per block, the deduplicated set of
    quantized grid cells its real cells occupy, as a
    ``(fine, coarse)`` pair of (m, d)/(mc, d) int64 arrays — fine cells
    on a ``scale``-step grid, coarse cells ``BITMAP_COARSE``× wider
    (``fine // BITMAP_COARSE``; floor division keeps negative
    coordinates on the same grid). Stored sparse — the occupied-cell
    set IS the bitmap, just run-length-free — because a kernel block
    holds at most 128 cells, so the set is tiny regardless of the grid's
    nominal extent."""
    c = coords.astype(np.int64, copy=False)
    fine_all = np.floor_divide(c, scale)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for i0 in range(0, c.shape[0], block):
        fine = np.unique(fine_all[i0:i0 + block], axis=0)
        coarse = np.unique(np.floor_divide(fine, BITMAP_COARSE), axis=0)
        out.append((fine, coarse))
    return out


def min_l1_cell_dist(cells_a: np.ndarray, cells_b: np.ndarray,
                     step: int) -> int:
    """Minimal L1 distance provable between any two real cells drawn
    from two occupied quantized-cell sets on a ``step``-wide grid.
    Quantized cell ``k`` covers the closed coordinate interval
    ``[k*step, (k+1)*step - 1]`` per dimension, so two distinct cells
    ``|dc|`` apart contribute a gap of ``(|dc| - 1)*step + 1`` (zero
    when equal) — summed over dimensions and minimized over all cell
    pairs. Lower-bounds the true distance of every real cell pair
    (exact at ``step = 1``); the soundness condition of the bitmap
    prune, property-tested in ``test_hypothesis_properties``."""
    d = np.abs(cells_a[:, None, :] - cells_b[None, :, :])
    gap = np.where(d > 0, (d - 1) * int(step) + 1, 0).sum(axis=-1)
    return int(gap.min())


def refine_block_pairs(pairs: np.ndarray,
                       bm_a: List[Tuple[np.ndarray, np.ndarray]],
                       bm_b: List[Tuple[np.ndarray, np.ndarray]],
                       eps: int, scale: int
                       ) -> Tuple[np.ndarray, int]:
    """Cell-exact refinement of a bbox-surviving (P, 3) block-pair list
    against the two sides' hierarchical bitmaps: a pair is killed when
    its blocks' occupied cells are provably more than eps apart —
    coarse level first (few cells, ``BITMAP_COARSE * scale``-wide, so
    most far pairs die on the cheap summary), fine level only for
    coarse survivors. The sparse min-distance test is equivalent to
    dilating one side's bitmap by eps and intersecting with the other
    (a cell pair within eps exists iff the dilated sets intersect), but
    runs directly on the occupied-cell sets — at most 128×128
    comparisons per pair. Returns ``(refined_pairs, killed)``; sound by
    :func:`min_l1_cell_dist`, so refined lists preserve exact match
    counts."""
    if pairs.shape[0] == 0:
        return pairs, 0
    coarse_step = int(scale) * BITMAP_COARSE
    keep = np.ones(pairs.shape[0], dtype=bool)
    for r in range(pairs.shape[0]):
        fa, ca = bm_a[int(pairs[r, 0])]
        fb, cb = bm_b[int(pairs[r, 1])]
        if min_l1_cell_dist(ca, cb, coarse_step) > eps:
            keep[r] = False
        elif min_l1_cell_dist(fa, fb, int(scale)) > eps:
            keep[r] = False
    refined = pairs[keep]
    return refined, int(pairs.shape[0] - refined.shape[0])


def pad_pairs(pairs: np.ndarray, to_len: int) -> np.ndarray:
    """Pad a (P, 3) pair list to ``to_len`` rows with invalid
    ``(0, 0, 0)`` entries — the kernel multiplies their counts away.
    An oversize pair list raises ``ValueError`` (a real error, not an
    ``assert``: silent truncation here would drop matches, and asserts
    vanish under ``python -O``)."""
    if pairs.shape[0] == to_len:
        return pairs
    if pairs.shape[0] > to_len:
        raise ValueError(
            f"pair list of shape {pairs.shape} does not fit the padded "
            f"length {to_len}; pad_pairs only grows pair lists")
    out = np.zeros((to_len, 3), np.int32)
    out[:pairs.shape[0]] = pairs
    return out

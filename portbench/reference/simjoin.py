"""The L1 similarity self-join of the cells inside a query box, counted:
unordered pairs of distinct cells whose coordinates lie within ``eps`` of
each other in the L1 norm. Exact integer arithmetic, on any device."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

#: Rows and partner columns a block of the sweep compares at once.
BLOCK_ROWS = 4096
BLOCK_COLS = 16384


def cells_in_box(coords: torch.Tensor, box: Tuple[Sequence[int],
                                                  Sequence[int]]
                 ) -> torch.Tensor:
    """The rows of ``coords`` (n, d) inside the box, bounds included."""
    lo = torch.as_tensor(box[0], dtype=coords.dtype, device=coords.device)
    hi = torch.as_tensor(box[1], dtype=coords.dtype, device=coords.device)
    return coords[((coords >= lo) & (coords <= hi)).all(dim=1)]


def count_pairs(cells: torch.Tensor, eps: int, dtype=torch.int32) -> int:
    """Pairs i < j of ``cells`` (n, d) with sum_k |c_ik - c_jk| <= eps.

    The cells are sorted along their last axis; row i's partners then lie
    at j > i with c_j[-1] - c_i[-1] <= eps, so a block of rows meets only
    the rows up to the first that is further than ``eps`` past the
    block's last. ``dtype`` is the arithmetic of the distance: int32 by
    default, exact while d times the largest coordinate stays below 2**31
    (the control passes a lower precision)."""
    n = cells.shape[0]
    if n < 2:
        return 0
    key = cells[:, -1]
    order = torch.argsort(key, stable=True)
    c = cells[order].to(dtype)
    key = key[order]
    ends = torch.searchsorted(key, key + eps, right=True).cpu()
    total = torch.zeros((), dtype=torch.int64, device=c.device)
    for i0 in range(0, n, BLOCK_ROWS):
        i1 = min(i0 + BLOCK_ROWS, n)
        a = c[i0:i1]
        ii = torch.arange(i0, i1, device=c.device)[:, None]
        for j0 in range(i0, int(ends[i1 - 1]), BLOCK_COLS):
            j1 = min(j0 + BLOCK_COLS, int(ends[i1 - 1]))
            b = c[j0:j1]
            dist = (a[:, None, 0] - b[None, :, 0]).abs()
            for k in range(1, c.shape[1]):
                dist += (a[:, None, k] - b[None, :, k]).abs()
            jj = torch.arange(j0, j1, device=c.device)[None, :]
            total += ((dist <= eps) & (jj > ii)).sum()
    return int(total)

"""The join cells' raw arrays and query sequences.

PTF (the paper's section 4.1): ``candidates<bright, mag>[ra, dec, time]``,
one file a night; each night points the telescope at a few of a fixed
set of canonical sky fields, so files overlap in (ra, dec) over disjoint
time ranges and cells cluster inside them, with heavy-tailed file sizes.

What sets the work is data of the cell (``layout``: the canonical
fields, each file's population and the fields each night points at;
``boxes`` and ``sequence``: the queries). ``--seed`` draws the cells,
the pointing jitter and the order of the nights, so every seed joins the
same amount of work over different data."""
from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np


def _dedup(coords: np.ndarray, attrs: np.ndarray, hi: np.ndarray):
    """A sparse array holds at most one cell a coordinate: the first of
    each is kept, in order."""
    key = np.zeros(len(coords), np.int64)
    for k in range(coords.shape[1]):
        key = key * (int(hi[k]) + 1) + coords[:, k]
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return coords[keep], attrs[keep]


def ptf_files(p: Mapping, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The PTF files, a list of (coords (n, 3) int64, attrs (n, 2)
    float32)."""
    lo = np.asarray(p["domain_lo"], np.int64)
    hi = np.asarray(p["domain_hi"], np.int64)
    ra_hi, dec_hi, t_hi = (int(x) for x in hi)
    lay = p["layout"]
    n_files = len(lay["pops"])
    rng = np.random.default_rng(seed)
    nights = rng.permutation(n_files)
    night_len = max(2, t_hi // n_files)
    out = []
    for i in range(n_files):
        t0 = 1 + int(nights[i]) * night_len
        t1 = min(t_hi, t0 + night_len - 1)
        n = max(4, int(lay["pops"][i] / len(lay["pointing"][i])))
        parts = []
        for f in lay["pointing"][i]:
            f_ra, f_dec = lay["fields"][f]
            c_ra = np.clip(f_ra + rng.normal(0, ra_hi * 0.002), 1, ra_hi)
            c_dec = np.clip(f_dec + rng.normal(0, dec_hi * 0.002), 1,
                            dec_hi)
            parts.append(np.stack([rng.normal(c_ra, ra_hi * 0.01, n),
                                   rng.normal(c_dec, dec_hi * 0.01, n),
                                   rng.integers(t0, t1 + 1, n)], axis=1))
        coords = np.clip(np.concatenate(parts).round().astype(np.int64),
                         lo, hi)
        attrs = rng.normal(18.0, 2.0, (coords.shape[0], 2)).astype(
            np.float32)
        out.append(_dedup(coords, attrs, hi))
    return out


def query_box(p: Mapping, i: int) -> Tuple[Tuple[int, ...],
                                            Tuple[int, ...]]:
    """The box of the closed loop's ``i``-th query (0-based): the cell's
    ``sequence`` of box indices, cycled."""
    seq = p["sequence"]
    lo, hi = p["boxes"][seq[i % len(seq)]]
    return tuple(lo), tuple(hi)

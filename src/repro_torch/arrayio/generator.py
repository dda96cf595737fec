"""Synthetic skewed sparse-array dataset generators (PTF-like and GEO-like).

PTF (§4.1): candidates<bright,mag>[ra, dec, time] — one file per night, each
night points the telescope at a handful of sky fields, so files cover large,
*overlapping* ranges while cells cluster heavily inside them (high variance:
sparse files with tens of cells, skewed files with millions).

GEO (§4.1): 2-D (long, lat) points of interest, each original point fanned
out with Gaussian offsets, split into equal files.

Sizes are fully parameterized so CI runs a small replica of the paper setup
and ``--scale full`` reproduces the published dimensions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.geometry import Box


@dataclasses.dataclass
class GeneratedFile:
    """One synthetic raw file: cell coordinates, attributes, and its
    acquisition-time bounding box."""

    coords: np.ndarray          # (n, d) int64
    attrs: np.ndarray           # (n, m) float32
    box: Box                    # acquisition-time bounding box (catalog input)


def _clip(coords: np.ndarray, domain: Box) -> np.ndarray:
    lo, hi = domain.as_arrays()
    return np.clip(coords, lo, hi)


def _dedup(coords: np.ndarray, attrs: np.ndarray):
    """Sparse arrays hold at most one cell per coordinate."""
    _, keep = np.unique(coords, axis=0, return_index=True)
    keep.sort()
    return coords[keep], attrs[keep]


def make_ptf_files(n_files: int = 16,
                   cells_per_file_mean: int = 4000,
                   skew: float = 1.4,
                   fields_per_night: int = 3,
                   n_canonical_fields: int = 8,
                   domain: Optional[Box] = None,
                   seed: int = 7) -> List[GeneratedFile]:
    """PTF-like [ra, dec, time] catalog, one file per 'night'.

    The survey re-images a fixed set of *canonical fields* night after night
    (transient detection compares detections at the same coordinates across
    time), so files overlap heavily in (ra, dec) while covering disjoint
    time ranges — the structure that makes cross-file similarity joins and
    shared-range caching matter."""
    rng = np.random.default_rng(seed)
    if domain is None:
        domain = Box((1, 1, 1), (100_000, 50_000, 153_064))
    ra_hi, dec_hi, t_hi = domain.hi
    # Telescope latitude bias: dec is skewed around one band of the sky.
    dec_center = int(0.55 * dec_hi)
    fields = [(int(rng.integers(1, ra_hi + 1)),
               int(np.clip(rng.normal(dec_center, dec_hi * 0.12), 1,
                           dec_hi)))
              for _ in range(n_canonical_fields)]
    night_len = max(2, t_hi // max(n_files, 1))
    # Zipf-ish heavy tail over file populations (paper: high variance).
    pops = (cells_per_file_mean *
            (rng.pareto(skew, size=n_files) + 0.05)).astype(np.int64)
    pops = np.maximum(pops, 16)
    files: List[GeneratedFile] = []
    for i in range(n_files):
        t0 = 1 + i * night_len
        t1 = min(t_hi, t0 + night_len - 1)
        parts = []
        for _ in range(fields_per_night):
            # A pointing: one canonical field (with jitter) this night.
            f_ra, f_dec = fields[int(rng.integers(0, n_canonical_fields))]
            c_ra = int(np.clip(f_ra + rng.normal(0, ra_hi * 0.002), 1,
                               ra_hi))
            c_dec = int(np.clip(f_dec + rng.normal(0, dec_hi * 0.002), 1,
                                dec_hi))
            n = max(4, int(pops[i] / fields_per_night))
            ra = rng.normal(c_ra, ra_hi * 0.01, n)
            dec = rng.normal(c_dec, dec_hi * 0.01, n)
            t = rng.integers(t0, t1 + 1, n)
            parts.append(np.stack([ra, dec, t], axis=1))
        coords = _clip(np.concatenate(parts).round().astype(np.int64), domain)
        attrs = rng.normal(18.0, 2.0, (coords.shape[0], 2)).astype(np.float32)
        coords, attrs = _dedup(coords, attrs)
        lo = coords.min(axis=0);  hi = coords.max(axis=0)
        files.append(GeneratedFile(coords, attrs,
                                   Box(tuple(map(int, lo)), tuple(map(int, hi)))))
    return files


def make_geo_files(n_files: int = 16,
                   n_seeds: int = 400,
                   clones_per_seed: int = 40,
                   sigma: float = 500.0,
                   domain: Optional[Box] = None,
                   seed: int = 11) -> List[GeneratedFile]:
    """GEO-like 2-D POI dataset: seed points + Gaussian clones (§4.1),
    split round-robin into equal files (paper: 8,000 equal files)."""
    rng = np.random.default_rng(seed)
    if domain is None:
        domain = Box((1, 1), (100_000, 50_000))
    lon_hi, lat_hi = domain.hi
    seeds = np.stack([rng.integers(1, lon_hi + 1, n_seeds),
                      rng.integers(1, lat_hi + 1, n_seeds)], axis=1)
    pts = seeds[:, None, :] + rng.normal(0, sigma,
                                         (n_seeds, clones_per_seed, 2))
    pts = pts.reshape(-1, 2)
    pts = np.concatenate([seeds, pts], axis=0)
    coords = _clip(pts.round().astype(np.int64), domain)
    rng.shuffle(coords, axis=0)
    per = len(coords) // n_files
    files: List[GeneratedFile] = []
    for i in range(n_files):
        c = coords[i * per:(i + 1) * per if i < n_files - 1 else None]
        a = rng.normal(0.0, 1.0, (c.shape[0], 1)).astype(np.float32)
        c, a = _dedup(c, a)
        lo = c.min(axis=0);  hi = c.max(axis=0)
        files.append(GeneratedFile(c, a,
                                   Box(tuple(map(int, lo)), tuple(map(int, hi)))))
    return files

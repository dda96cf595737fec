"""Query workload generators mirroring §4.1: PTF-1, PTF-2, GEO, and the
100-query stress workload.

  * PTF-1 — data-exploration joins through all detections on the time
    dimension: random compact (ra, dec) fields, full time range, with range
    re-use across the workload (shared ranges drive the 20x wins in Fig. 5).
  * PTF-2 — 4 range-shifted queries, enlarged 2x on ra and 2x on dec,
    alternating 1,2,3,4,1,2,3,4,1,2.
  * GEO  — fixed-size range shifted by a constant latitude step 1..5 then
    reversed: 1,2,3,4,5,5,4,3,2,1.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.coordinator import SimilarityJoinQuery
from repro_torch.core.geometry import Box


def _clip_box(lo, hi, domain: Box) -> Box:
    lo = tuple(int(max(l, dl)) for l, dl in zip(lo, domain.lo))
    hi = tuple(int(min(h, dh)) for h, dh in zip(hi, domain.hi))
    hi = tuple(max(l, h) for l, h in zip(lo, hi))
    return Box(lo, hi)


def ptf1_workload(domain: Box, n_queries: int = 10, eps: int = 1,
                  field_frac: float = 0.08, seed: int = 3,
                  anchors: Optional[Sequence[Tuple[int, int]]] = None
                  ) -> List[SimilarityJoinQuery]:
    """Random sky fields over (ra, dec), joining through all of time. Every
    other query revisits a previous field (ranges shared across workload).
    ``anchors``: optional (ra, dec) points the exploration targets (e.g.
    observed detections) — without them fields are uniform over the domain.
    """
    rng = np.random.default_rng(seed)
    ra_n, dec_n = domain.side(0), domain.side(1)
    w = max(1, int(ra_n * field_frac))
    h = max(1, int(dec_n * field_frac))
    queries: List[SimilarityJoinQuery] = []
    fields = []
    for i in range(n_queries):
        if fields and i % 2 == 1:
            ra0, dec0 = fields[rng.integers(0, len(fields))]
            ra0 += int(rng.integers(-w // 4, w // 4 + 1))
            dec0 += int(rng.integers(-h // 4, h // 4 + 1))
        else:
            if anchors is not None:
                a_ra, a_dec = anchors[int(rng.integers(0, len(anchors)))]
                ra0 = int(a_ra) - w // 2
                dec0 = int(a_dec) - h // 2
            else:
                ra0 = int(rng.integers(domain.lo[0], domain.hi[0] - w + 1))
                dec0 = int(rng.integers(domain.lo[1], domain.hi[1] - h + 1))
            fields.append((ra0, dec0))
        box = _clip_box((ra0, dec0, domain.lo[2]),
                        (ra0 + w - 1, dec0 + h - 1, domain.hi[2]), domain)
        queries.append(SimilarityJoinQuery(box=box, eps=eps))
    return queries


def ptf2_workload(domain: Box, n_queries: int = 10, eps: int = 1,
                  field_frac: float = 0.08, seed: int = 5,
                  anchors: Optional[Sequence[Tuple[int, int]]] = None
                  ) -> List[SimilarityJoinQuery]:
    """4 shifted base ranges enlarged 2x on ra and 2x on dec, alternating."""
    rng = np.random.default_rng(seed)
    ra_n, dec_n = domain.side(0), domain.side(1)
    w = max(1, int(ra_n * field_frac * 2))
    h = max(1, int(dec_n * field_frac * 2))
    bases = []
    if anchors is not None:
        a_ra, a_dec = anchors[int(rng.integers(0, len(anchors)))]
        ra0, dec0 = int(a_ra) - w // 2, int(a_dec) - h // 2
    else:
        ra0 = int(rng.integers(domain.lo[0], max(domain.lo[0] + 1,
                                                 domain.hi[0] - 2 * w)))
        dec0 = int(rng.integers(domain.lo[1], max(domain.lo[1] + 1,
                                                  domain.hi[1] - 2 * h)))
    for k in range(4):
        bases.append((ra0 + k * w // 3, dec0 + k * h // 3))
    queries = []
    for i in range(n_queries):
        bra, bdec = bases[i % 4]
        box = _clip_box((bra, bdec, domain.lo[2]),
                        (bra + w - 1, bdec + h - 1, domain.hi[2]), domain)
        queries.append(SimilarityJoinQuery(box=box, eps=eps))
    return queries


def geo_workload(domain: Box, eps: int = 1, range_frac: float = 0.12,
                 step_frac: float = 0.06, seed: int = 9
                 ) -> List[SimilarityJoinQuery]:
    """Shifting-latitude workload 1,2,3,4,5 then 5,4,3,2,1 (§4.1)."""
    rng = np.random.default_rng(seed)
    lon_n, lat_n = domain.side(0), domain.side(1)
    w = max(1, int(lon_n * range_frac))
    h = max(1, int(lat_n * range_frac))
    step = max(1, int(lat_n * step_frac))
    lon0 = int(rng.integers(domain.lo[0], max(domain.lo[0] + 1,
                                              domain.hi[0] - w)))
    lat0 = int(rng.integers(domain.lo[1], max(domain.lo[1] + 1,
                                              domain.hi[1] - h - 5 * step)))
    forward = []
    for k in range(5):
        box = _clip_box((lon0, lat0 + k * step),
                        (lon0 + w - 1, lat0 + k * step + h - 1), domain)
        forward.append(SimilarityJoinQuery(box=box, eps=eps))
    return forward + forward[::-1]


def zipf_workload(domain: Box, n_queries: int = 200, n_templates: int = 30,
                  s: float = 1.1, eps: int = 1, field_frac: float = 0.08,
                  seed: int = 7,
                  anchors: Optional[Sequence[Tuple[int, int]]] = None
                  ) -> List[SimilarityJoinQuery]:
    """Zipf-skewed repeat workload: a pool of ``n_templates`` distinct
    query boxes sampled once, then ``n_queries`` draws with rank-``k``
    probability p_k ∝ 1/k^s — the "millions of users" traffic shape the
    result-cache/MQO tiers target (most queries are exact repeats of a
    few hot templates; the tail still exercises cold paths). Fully
    seeded: identical arguments yield an identical query list.
    ``anchors`` targets template fields at observed detections, as in
    :func:`ptf1_workload`. Fields span the first two dimensions; any
    further dimensions (e.g. PTF's time axis) are queried in full."""
    rng = np.random.default_rng(seed)
    ra_n, dec_n = domain.side(0), domain.side(1)
    w = max(1, int(ra_n * field_frac))
    h = max(1, int(dec_n * field_frac))
    rest_lo = tuple(domain.lo[2:])
    rest_hi = tuple(domain.hi[2:])
    templates: List[SimilarityJoinQuery] = []
    for _ in range(n_templates):
        if anchors is not None:
            a_ra, a_dec = anchors[int(rng.integers(0, len(anchors)))]
            ra0, dec0 = int(a_ra) - w // 2, int(a_dec) - h // 2
        else:
            ra0 = int(rng.integers(domain.lo[0], domain.hi[0] - w + 1))
            dec0 = int(rng.integers(domain.lo[1], domain.hi[1] - h + 1))
        box = _clip_box((ra0, dec0) + rest_lo,
                        (ra0 + w - 1, dec0 + h - 1) + rest_hi, domain)
        templates.append(SimilarityJoinQuery(box=box, eps=eps))
    ranks = np.arange(1, len(templates) + 1, dtype=np.float64)
    probs = ranks ** -float(s)
    probs /= probs.sum()
    draws = rng.choice(len(templates), size=n_queries, p=probs)
    return [templates[int(k)] for k in draws]


def ptf_stress_workload(domain: Box, n_queries: int = 100, eps: int = 1,
                        seed: int = 17,
                        anchors: Optional[Sequence[Tuple[int, int]]] = None
                        ) -> List[SimilarityJoinQuery]:
    """100 real-workload-style queries: a mix of exploration, revisits, and
    range shifts (§4.2.2)."""
    rng = np.random.default_rng(seed)
    out: List[SimilarityJoinQuery] = []
    p1 = ptf1_workload(domain, n_queries=max(4, n_queries // 2), eps=eps,
                       seed=seed, anchors=anchors)
    p2 = ptf2_workload(domain, n_queries=max(4, n_queries // 3), eps=eps,
                       seed=seed + 1, anchors=anchors)
    pool = p1 + p2
    while len(out) < n_queries:
        out.append(pool[int(rng.integers(0, len(pool)))])
    return out[:n_queries]

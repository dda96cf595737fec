"""Similarity-join planning over cached chunks (§2.2, derived from [63]).

Given the queried chunks (with current locations) and the join shape radius
``eps`` (L^1 / L^inf neighborhood), the planner:

  1. enumerates candidate chunk pairs — pairs whose bounding boxes, one side
     expanded by ``eps``, overlap (a superset of the true joining pairs);
  2. assigns every pair to a node minimizing shipped bytes, breaking ties by
     projected compute load (|C_i| * |C_j| cell-pair work), which yields the
     transfer/balance trade-off the optimizer in [63] targets;
  3. emits the per-node execution sub-plan and the transfer list. Every
     shipped chunk creates a *replica* — the input that cache placement
     (Alg. 3) later consolidates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.chunk import ChunkMeta
from repro_torch.core.geometry import Box, expand

# A chunk's starting location as handed to the planner: a bare node id
# (single copy — the seed shape) or an ordered replica tuple, primary
# first (hot-chunk replication). Both normalize through one path, so the
# single-copy plan is bit-identical whichever form the caller passes.
PlanLocation = Union[int, Tuple[int, ...]]


@dataclasses.dataclass
class JoinPlan:
    """A query's join execution plan: pair assignments, transfers, and
    the per-node byte/compute loads the §4.1 cost model charges."""

    pairs: List[Tuple[int, int]]                 # candidate chunk-id pairs
    pair_node: Dict[Tuple[int, int], int]        # pair -> executing node
    transfers: List[Tuple[int, int]]             # (chunk_id, dest node)
    transfer_routes: List[Tuple[int, int, int]]  # (chunk_id, src, dest):
    # the same ship decisions as ``transfers`` with the source node
    # recorded, so a device-backed execution backend can replay each
    # decision as a real src -> dest transfer.
    bytes_in: Dict[int, int]                     # per-node received bytes
    bytes_out: Dict[int, int]                    # per-node sent bytes
    compute_load: Dict[int, int]                 # per-node cell-pair work
    replicas: Dict[int, Set[int]]                # chunk -> nodes holding it
    # Pair-sides served in place by a SECONDARY replica (a pre-existing
    # non-primary copy — not a copy this plan shipped): the observable
    # proving replication absorbed work the primary would otherwise
    # serialize. Always 0 with single-valued locations.
    replica_hits: int = 0


def candidate_pairs(chunks: Sequence[ChunkMeta], eps: int,
                    query: Optional[Box] = None) -> List[Tuple[int, int]]:
    """Self-join candidate pairs (i <= j), including the self pair, for
    chunks whose eps-expanded boxes overlap."""
    out: List[Tuple[int, int]] = []
    metas = sorted(chunks, key=lambda c: c.chunk_id)
    for a in range(len(metas)):
        ca = metas[a]
        grown = expand(ca.box, eps)
        for b in range(a, len(metas)):
            cb = metas[b]
            if a == b or grown.overlaps(cb.box):
                out.append((ca.chunk_id, cb.chunk_id))
    return out


def plan_join(chunks: Sequence[ChunkMeta],
              locations: Dict[int, PlanLocation],
              eps: int,
              n_nodes: int,
              ship_bytes: Optional[Dict[int, int]] = None) -> JoinPlan:
    """Assign candidate pairs to nodes. ``locations[c]`` is where chunk ``c``
    is resident when the query starts (cache location, or the home node right
    after a raw scan): a bare node id, or a primary-first replica tuple
    when hot-chunk replication holds several copies. Every holder seeds
    ``node_has``, so the greedy (ship bytes, balance penalty) cost
    naturally routes each pair to its least-loaded replica; transfers
    source from the original holder with the least outbound pressure.

    ``ship_bytes`` optionally overrides the per-chunk transfer cost: the
    semantic-reuse layer charges a covering cached chunk only for the
    extent sliced to the query region (cells inside the query box), not the
    whole chunk — the owning node slices in place and ships the slice."""
    meta = {c.chunk_id: c for c in chunks}
    wire = {c.chunk_id: c.nbytes for c in chunks}
    if ship_bytes:
        wire.update((cid, b) for cid, b in ship_bytes.items() if cid in wire)
    pairs = candidate_pairs(chunks, eps)
    # Order pairs by decreasing work so the balance heuristic sees the big
    # rocks first (classic LPT scheduling).
    pairs.sort(key=lambda p: -(meta[p[0]].n_cells * meta[p[1]].n_cells))

    # Normalize every location through ONE path (int -> one-tuple), so
    # the single-copy plan is identical whichever form the caller passed.
    holders: Dict[int, Tuple[int, ...]] = {
        cid: (loc if isinstance(loc, tuple) else (int(loc),))
        for cid, loc in locations.items()}
    primary: Dict[int, int] = {cid: reps[0] for cid, reps in holders.items()}
    node_has: Dict[int, Set[int]] = {n: set() for n in range(n_nodes)}
    for cid, reps in holders.items():
        for node in reps:
            node_has[node].add(cid)
    load: Dict[int, int] = {n: 0 for n in range(n_nodes)}
    bytes_in: Dict[int, int] = {n: 0 for n in range(n_nodes)}
    bytes_out: Dict[int, int] = {n: 0 for n in range(n_nodes)}
    pair_node: Dict[Tuple[int, int], int] = {}
    transfers: List[Tuple[int, int]] = []
    routes: List[Tuple[int, int, int]] = []

    mean_load_target = (sum(meta[a].n_cells * meta[b].n_cells
                            for a, b in pairs) / max(n_nodes, 1)) or 1.0

    replica_hits = 0
    for a, b in pairs:
        ca, cb = meta[a], meta[b]
        work = ca.n_cells * cb.n_cells
        best_node, best_cost = None, None
        for n in range(n_nodes):
            ship = 0
            if a not in node_has[n]:
                ship += wire[a]
            if b not in node_has[n] and a != b:
                ship += wire[b]
            # Cost: bytes shipped, with a balance penalty proportional to the
            # node's projected overload (keeps the plan from piling compute
            # on the chunk-rich node).
            cost = (ship, max(0.0, (load[n] + work) / mean_load_target - 1.0))
            if best_cost is None or cost < best_cost:
                best_node, best_cost = n, cost
        n = best_node
        assert n is not None
        pair_node[(a, b)] = n
        load[n] += work
        for cid in {a, b}:
            if cid not in node_has[n]:
                # Ship from the ORIGINAL holder with the least outbound
                # pressure (deterministic tie-break: tuple order, which
                # is primary-first) — the single-holder case reduces to
                # the seed's ``src = locations[cid]``.
                src = min(holders[cid],
                          key=lambda s: (bytes_out[s],
                                         holders[cid].index(s)))
                node_has[n].add(cid)
                transfers.append((cid, n))
                routes.append((cid, src, n))
                bytes_in[n] += wire[cid]
                bytes_out[src] += wire[cid]
            elif n in holders[cid] and n != primary[cid]:
                # Served in place by a pre-existing secondary copy.
                replica_hits += 1

    replicas: Dict[int, Set[int]] = {}
    for cid in meta:
        replicas[cid] = {n for n in range(n_nodes) if cid in node_has[n]}
    return JoinPlan(pairs=pairs, pair_node=pair_node, transfers=transfers,
                    transfer_routes=routes, bytes_in=bytes_in,
                    bytes_out=bytes_out, compute_load=load,
                    replicas=replicas, replica_hits=replica_hits)

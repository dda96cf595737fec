"""Cache placement: co-locality-maximizing replica selection (§3.4, Alg. 3).

After a join executes, chunks have replicas at their home node and at every
node the join plan shipped them to. Placement keeps exactly one copy of each
cached chunk, chosen to maximize the decayed co-location benefit

    cost(C_i, n, P', W) = sum_{Q in W} w_Q * |{C_j in P'_n : (C_i,C_j) in Q}|

subject to per-node byte budgets, visiting chunks in increasing replica count
(chunks with many replicas keep more options as budgets tighten). Candidate
nodes are the replica holders — placement *piggybacks* on the transfers the
join already performed and never ships new bytes (§3.4): when no replica
node has budget left the chunk is dropped from cache rather than shipped
(``allow_fallback_ship=True`` restores the shipping variant, whose transfer
bytes are then charged as ``fallback_moves``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class JoinRecord:
    """(Q_l, {(C_i, C_j)}) — chunk pairs joined at query l (input W)."""

    query_index: int
    pairs: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class PlacementResult:
    """Output of one placement round: final locations, paid fallback
    transfers, and chunks dropped for lack of budget (Alg. 3)."""

    locations: Dict[int, int]          # chunk_id -> node
    fallback_moves: List[Tuple[int, int]]   # (chunk_id, node) paid transfers
    dropped: List[int]                 # chunks that fit nowhere
    colocated_pair_weight: float       # achieved objective value


def _pair_weights(workload: Sequence[JoinRecord], latest_index: int,
                  decay: float, window: int) -> Dict[int, Dict[int, float]]:
    """Aggregate w(C_i, C_j) = sum_Q w_Q [ (C_i,C_j) in Q ] as adjacency maps.

    Weights are normalized to w_Q = decay**(l - latest) in (0, 1] so long
    histories neither overflow nor matter beyond the effective window.
    """
    adj: Dict[int, Dict[int, float]] = {}
    for rec in workload:
        age = latest_index - rec.query_index
        if age >= window:
            continue
        w = decay ** (-age)
        for a, b in rec.pairs:
            if a == b:
                continue
            adj.setdefault(a, {})[b] = adj.setdefault(a, {}).get(b, 0.0) + w
            adj.setdefault(b, {})[a] = adj.setdefault(b, {}).get(a, 0.0) + w
    return adj


def cost_based_placement(workload: Sequence[JoinRecord],
                         replicas: Dict[int, Set[int]],
                         chunk_bytes: Dict[int, int],
                         node_budgets: Dict[int, int],
                         decay: float = 2.0,
                         window: int = 64,
                         allow_fallback_ship: bool = False
                         ) -> PlacementResult:
    """Alg. 3. ``replicas[c]`` is the set of nodes holding a copy of cached
    chunk ``c`` after query execution; ``node_budgets`` are per-node byte
    budgets B_k."""
    latest = max((r.query_index for r in workload), default=0)
    adj = _pair_weights(workload, latest, decay, window)
    free = dict(node_budgets)
    locations: Dict[int, int] = {}
    fallback: List[Tuple[int, int]] = []
    dropped: List[int] = []
    objective = 0.0

    def colocation_gain(cid: int, node: int) -> float:
        total = 0.0
        for partner, w in adj.get(cid, {}).items():
            if locations.get(partner) == node:
                total += w
        return total

    def try_place(cid: int, candidates: Iterable[int]) -> bool:
        nonlocal objective
        nb = chunk_bytes[cid]
        best_node, best_gain = None, -1.0
        for n in candidates:
            if free.get(n, 0) < nb:
                continue
            g = colocation_gain(cid, n)
            # Tie-break on free budget to balance load across nodes.
            if g > best_gain or (g == best_gain and best_node is not None
                                 and free[n] > free[best_node]):
                best_node, best_gain = n, g
        if best_node is None:
            return False
        locations[cid] = best_node
        free[best_node] -= nb
        objective += best_gain
        return True

    # Line 1: singleton-replica chunks are pinned where they are.
    singles = [c for c, nodes in replicas.items() if len(nodes) == 1]
    multi = [c for c, nodes in replicas.items() if len(nodes) > 1]
    for cid in singles:
        node = next(iter(replicas[cid]))
        nb = chunk_bytes[cid]
        if free.get(node, 0) >= nb:
            locations[cid] = node
            free[node] -= nb
            objective += colocation_gain(cid, node)
        elif allow_fallback_ship and try_place(
                cid, sorted(free, key=free.get, reverse=True)):
            fallback.append((cid, locations[cid]))
        else:
            dropped.append(cid)

    # Lines 2-5: multi-replica chunks in increasing replica count.
    for cid in sorted(multi, key=lambda c: (len(replicas[c]), c)):
        if try_place(cid, sorted(replicas[cid])):
            continue
        if allow_fallback_ship and try_place(
                cid, sorted(free, key=free.get, reverse=True)):
            fallback.append((cid, locations[cid]))
        else:
            dropped.append(cid)

    return PlacementResult(locations=locations, fallback_moves=fallback,
                           dropped=dropped, colocated_pair_weight=objective)


def static_placement(replicas: Dict[int, Set[int]],
                     home_node: Dict[int, int],
                     chunk_bytes: Dict[int, int],
                     node_budgets: Dict[int, int]) -> PlacementResult:
    """Baseline (§4.2.4 'static'): every chunk stays cached at its origin —
    the node where the raw file lives — regardless of the join workload."""
    free = dict(node_budgets)
    locations: Dict[int, int] = {}
    dropped: List[int] = []
    for cid in sorted(replicas):
        node = home_node[cid]
        nb = chunk_bytes[cid]
        if free.get(node, 0) >= nb:
            locations[cid] = node
            free[node] -= nb
        else:
            dropped.append(cid)
    return PlacementResult(locations=locations, fallback_moves=[],
                           dropped=dropped, colocated_pair_weight=0.0)

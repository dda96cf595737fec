"""Fault tolerance for 1000+-node runs: heartbeats, straggler detection,
checkpoint/restart supervision, and elastic re-meshing.

The elastic re-mesh reuses the *paper's own placement heuristic* (Alg. 3):
checkpoint shards are "chunks", shards of the same layer stack are
"join-correlated" (they are read together at restore), surviving hosts are
the nodes, and ``cost_based_placement`` redistributes the lost host's shards
while maximizing layer co-locality under per-host memory budgets — the same
code path that places array chunks places parameter shards. This is the
beyond-paper reuse documented in DESIGN.md §5.

Hardware is simulated (this container is one box): ``ClusterMonitor`` is fed
heartbeat/step-time observations by the harness or tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.placement import JoinRecord, cost_based_placement


@dataclasses.dataclass
class NodeState:
    """One node's last heartbeat, recent step times and liveness."""
    node_id: int
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


@dataclasses.dataclass
class StragglerReport:
    """Nodes slower than the threshold, the median step time and the
    threshold."""
    stragglers: List[int]
    median_step_s: float
    threshold_s: float


class ClusterMonitor:
    """Heartbeat + straggler tracking. ``heartbeat_timeout`` declares a node
    dead; step times beyond ``straggler_factor`` x median flag a straggler
    (candidate for data re-balancing or preemptive replacement)."""

    def __init__(self, n_nodes: int, heartbeat_timeout: float = 30.0,
                 straggler_factor: float = 1.5, window: int = 16,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.timeout = heartbeat_timeout
        self.factor = straggler_factor
        self.window = window
        now = clock()
        self.nodes = {i: NodeState(i, now) for i in range(n_nodes)}

    def heartbeat(self, node_id: int,
                  step_time_s: Optional[float] = None) -> None:
        """Record a heartbeat (and a step time) from ``node_id``."""
        st = self.nodes[node_id]
        st.last_heartbeat = self.clock()
        if step_time_s is not None:
            st.step_times.append(step_time_s)
            st.step_times = st.step_times[-self.window:]

    def dead_nodes(self) -> List[int]:
        """Nodes silent for longer than the timeout (marked dead)."""
        now = self.clock()
        out = []
        for st in self.nodes.values():
            if st.alive and now - st.last_heartbeat > self.timeout:
                st.alive = False
            if not st.alive:
                out.append(st.node_id)
        return out

    def stragglers(self) -> StragglerReport:
        """Alive nodes whose mean step time exceeds factor x median."""
        means = {i: float(np.mean(st.step_times))
                 for i, st in self.nodes.items()
                 if st.alive and st.step_times}
        if not means:
            return StragglerReport([], 0.0, 0.0)
        med = float(np.median(list(means.values())))
        thr = med * self.factor
        return StragglerReport(
            [i for i, m in means.items() if m > thr], med, thr)


@dataclasses.dataclass
class RemeshPlan:
    """The shrunk mesh and where each lost checkpoint shard goes."""
    old_dp: int
    new_dp: int
    mesh_shape: Tuple[int, ...]
    shard_moves: Dict[int, int]          # shard_id -> destination host
    dropped_batch_fraction: float


def plan_elastic_remesh(n_hosts_alive: int, model_parallel: int,
                        shard_sizes: Dict[int, int],
                        shard_layer: Dict[int, int],
                        lost_host_shards: Sequence[int],
                        host_budget_bytes: int,
                        current_host: Dict[int, int]) -> RemeshPlan:
    """Shrink the DP axis to the largest size the survivors support and
    redistribute the lost host's checkpoint shards via Alg. 3.

    ``shard_layer`` drives co-locality: shards of the same layer-period form
    join pairs so restore reads stay host-local."""
    new_dp = max(1, n_hosts_alive // model_parallel)
    # Join-correlate shards within a layer (they restore together).
    by_layer: Dict[int, List[int]] = {}
    for s, layer in shard_layer.items():
        by_layer.setdefault(layer, []).append(s)
    pairs = []
    for layer, shards in by_layer.items():
        shards = sorted(shards)
        pairs.extend((a, b) for i, a in enumerate(shards)
                     for b in shards[i + 1:])
    workload = [JoinRecord(1, tuple(pairs))]
    # Replicas: surviving shards stay put (single replica); lost shards may
    # go to any survivor (modeled as replicas everywhere).
    survivors = sorted(set(current_host.values()))[:n_hosts_alive]
    replicas: Dict[int, Set[int]] = {}
    for s in shard_sizes:
        if s in lost_host_shards:
            replicas[s] = set(survivors)
        else:
            replicas[s] = {current_host[s]}
    budgets = {h: host_budget_bytes for h in survivors}
    placement = cost_based_placement(workload, replicas, shard_sizes,
                                     budgets)
    moves = {s: n for s, n in placement.locations.items()
             if s in lost_host_shards or n != current_host.get(s)}
    return RemeshPlan(
        old_dp=(n_hosts_alive + 1) // model_parallel, new_dp=new_dp,
        mesh_shape=(new_dp, model_parallel),
        shard_moves=moves,
        dropped_batch_fraction=1.0 - new_dp * model_parallel /
        ((n_hosts_alive + 1) // model_parallel * model_parallel))


class TrainingSupervisor:
    """Checkpoint/restart supervisor: runs ``step_fn`` until ``total_steps``,
    checkpointing every ``ckpt_every``; on a (simulated) failure exception it
    restores the latest checkpoint and continues — the integration test
    injects failures and asserts bit-exact convergence with an uninterrupted
    run."""

    def __init__(self, checkpointer, restore_fn, ckpt_every: int = 10):
        self.ckpt = checkpointer
        self.restore_fn = restore_fn
        self.every = ckpt_every

    def run(self, state, step_fn, total_steps: int,
            failure_at: Optional[Set[int]] = None):
        """Run ``step_fn`` to ``total_steps``, checkpointing every
        ``ckpt_every`` steps; an injected failure (``failure_at``)
        restores the latest checkpoint and continues."""
        failure_at = failure_at or set()
        step = state["step"]
        while step < total_steps:
            try:
                if step in failure_at:
                    failure_at.discard(step)
                    raise RuntimeError(f"injected node failure at {step}")
                state = step_fn(state)
                step = state["step"]
                if step % self.every == 0:
                    self.ckpt.save(step, state["tree"],
                                   extra={"pipeline": state.get("pipeline",
                                                                {})})
            except RuntimeError:
                self.ckpt.wait()
                state = self.restore_fn()
                step = state["step"]
        self.ckpt.wait()
        return state

"""Pluggable execution backends for the caching cluster.

The planning layers (``repro_torch.core``) decide *what* to scan, ship,
and join; an :class:`~repro_torch.backend.base.ExecutionBackend` decides
*how* those decisions are carried out:

  * ``"simulated"`` — the paper's §4.1 analytical cost model
    (:class:`~repro_torch.backend.simulated.SimulatedBackend`): bytes and
    match counts are exact, wall-clock is modeled from calibrated
    bandwidths.
  * ``"torch_device"`` — real execution over torch devices
    (:class:`~repro_torch.backend.torch_device.TorchDeviceBackend`):
    paper *nodes* map onto devices (wrapping onto one card when there
    are fewer cards than nodes), cached chunks are committed as
    device-resident tensors, the join plan's ship decisions become
    actual cross-device copies with measured bytes and wall-clock, and
    each node's shape-bucketed simjoin batch dispatches to the CUDA
    kernels on that node's device.

Both backends execute the *same* plans from the same coordinator, so
planned byte accounting is identical by construction — the device
backend adds measured quantities on top instead of replacing them.
"""
from repro_torch.backend.artifacts import (ChunkView, JoinArtifactCache,
                                           subset_token, task_coords)
from repro_torch.backend.base import (BACKENDS, DeviceBindingListener,
                                      ExecutedQuery, ExecutionBackend,
                                      workload_summary)
from repro_torch.backend.cost_model import CostModel
from repro_torch.backend.executors import (JOIN_BACKENDS, PRUNE_MODES,
                                           JoinTask, NumpyJoinExecutor,
                                           PreparedBatch, TorchJoinExecutor,
                                           count_similar_pairs_np,
                                           make_join_executor)
from repro_torch.backend.simulated import MQO_MODES, SimulatedBackend
from repro_torch.backend.torch_device import TorchDeviceBackend, make_backend

__all__ = [
    "BACKENDS", "ChunkView", "CostModel", "DeviceBindingListener",
    "ExecutedQuery", "ExecutionBackend", "JOIN_BACKENDS",
    "JoinArtifactCache", "JoinTask", "MQO_MODES", "NumpyJoinExecutor",
    "PRUNE_MODES", "PreparedBatch", "SimulatedBackend",
    "TorchDeviceBackend", "TorchJoinExecutor", "count_similar_pairs_np",
    "make_backend", "make_join_executor", "subset_token", "task_coords",
    "workload_summary",
]

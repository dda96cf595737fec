"""Core of the paper: distributed cost-based caching for raw arrays,
grown into a layered planning engine.

Public API by layer:
  * geometry.Box — integer hyper-rectangles (+ box_subtract residuals)
  * rtree.EvolvingRTree — query-driven chunking (Alg. 1)
  * chunk_manager.ChunkManager — chunk lifecycle, split remap, size tables
  * cache_state.CacheState — residency, locations, budget scopes
  * coverage.CoverageIndex — semantic cache reuse: covered-extent index
    and query rewrite (covered slices + residual region)
  * eviction.cost_based_eviction — Alg. 2 (+ LRU/LFU cache structures)
  * placement.cost_based_placement — Alg. 3 (+ static baseline)
  * policies — EvictionPolicy/PlacementPolicy protocols + combo registry
  * coordinator.CacheCoordinator — the Figure-2 pipeline; batched admission
  * cluster.RawArrayCluster — shared-nothing execution façade over the
    pluggable backends in ``repro_torch.backend`` (simulated §4.1 cost
    model, or real torch devices with measured transfers + CUDA joins)
  * workload — PTF-1 / PTF-2 / GEO query generators
"""
from repro_torch.core.geometry import (Box, bounding_box, box_subtract, expand,
                                 residual_boxes)
from repro_torch.core.chunk import Chunk, ChunkMeta, FileMeta
from repro_torch.core.rtree import EvolvingRTree, RefineStats
from repro_torch.core.chunk_manager import ChunkManager
from repro_torch.core.cache_state import CacheState
from repro_torch.core.coverage import CoverageIndex, CoveredSlice, QueryRewrite
from repro_torch.core.eviction import (LFUCache, LRUCache, Triple, EvictionResult,
                                 cost_based_eviction)
from repro_torch.core.placement import (JoinRecord, PlacementResult,
                                  cost_based_placement, static_placement)
from repro_torch.core.policies import (POLICIES, POLICY_REGISTRY, PolicySpec,
                                 register_policy, resolve_policy)
from repro_torch.core.join_planner import JoinPlan, candidate_pairs, plan_join
from repro_torch.core.result_cache import (RESULT_CACHE_MODES, ResultCache,
                                     ResultEntry)
from repro_torch.core.coordinator import (CacheCoordinator, QueryReport,
                                    SimilarityJoinQuery)
from repro_torch.core.cluster import (BACKENDS, CostModel, ExecutedQuery,
                                NumpyJoinExecutor, TorchJoinExecutor,
                                RawArrayCluster, count_similar_pairs_np,
                                make_backend, workload_summary)

__all__ = [
    "Box", "bounding_box", "box_subtract", "expand", "residual_boxes",
    "Chunk", "ChunkMeta", "FileMeta",
    "EvolvingRTree", "RefineStats", "ChunkManager", "CacheState",
    "CoverageIndex", "CoveredSlice", "QueryRewrite",
    "LFUCache", "LRUCache", "Triple", "EvictionResult",
    "cost_based_eviction", "JoinRecord", "PlacementResult",
    "cost_based_placement", "static_placement", "POLICIES",
    "POLICY_REGISTRY", "PolicySpec", "register_policy", "resolve_policy",
    "JoinPlan", "candidate_pairs", "plan_join", "RESULT_CACHE_MODES",
    "ResultCache", "ResultEntry", "CacheCoordinator",
    "QueryReport", "SimilarityJoinQuery", "BACKENDS", "CostModel",
    "ExecutedQuery", "NumpyJoinExecutor", "TorchJoinExecutor",
    "RawArrayCluster", "count_similar_pairs_np", "make_backend",
    "workload_summary",
]

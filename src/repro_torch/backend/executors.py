"""Join executors: per-node grouped chunk-pair work -> match counts
(extracted from ``repro_torch.core.cluster``).

  * ``"numpy"``  — the reference executor: one blocked numpy evaluation
    per chunk pair (``join_fn`` override preserved).
  * ``"torch"`` — the batched executor: each node's chunk-pair work is
    grouped, coordinate sets are padded to the kernel's 128-wide BLOCK,
    and shape-bucketed pair batches are dispatched to the
    ``kernels/simjoin`` CUDA kernels on the card (or their plain PyTorch
    versions, for ``device="cpu"`` or ``impl="plain"``). Its ``prune``
    knob selects the grid per task:

      - ``"dense"`` — every block pair evaluated (the parity reference);
      - ``"block"`` — coordinates spatially sorted, per-block bounding
        boxes pruned against ``eps`` on host, only live block pairs
        handed to the pair-list kernel (``kernels.simjoin.prune``);
      - ``"bitmap"`` — the bbox-pruned pair list is refined by a second,
        cell-exact stage: hierarchical occupancy bitmaps per block
        (``prune.build_bitmaps``) are intersected per surviving pair and
        pairs whose occupied cells are provably > eps apart are killed
        (``prune.refine_block_pairs``) before the list is padded and
        uploaded — strictly fewer live pairs, identical counts;
      - ``"auto"`` (default) — per task, the block-sparse grid only when
        it can win: a task goes dense when its *post-bitmap refined*
        pair list, padded, would be at least as long as the dense grid
        (``padded_pair_len(refined) >= dense blocks``), which covers
        single-block chunk pairs (a dense grid of 1 is below the minimum
        pad of 8) and near-dense pair lists in one rule — the block
        kernel's cost is proportional to the *padded* pair count, so
        this choice is never the slower one.

Host-side prep (sort, boxes, padding, pair lists) is memoized in a
:class:`repro_torch.backend.artifacts.JoinArtifactCache` when tasks carry
:class:`~repro_torch.backend.artifacts.ChunkView` handles (attached by the
backends, invalidated with cache residency); bare ndarray tasks prep
uncached, preserving the seed behavior for direct callers.

Every torch dispatch records ``last_stats``: ``block_pairs_total`` (the
dense grid size) and ``block_pairs_evaluated`` (block pairs actually
dispatched), plus ``prep_s``/``dispatch_s`` wall-clock and the query's
``artifact_hits``/``artifact_misses`` — the backends surface all of them
per query on ``ExecutedQuery``. When the bitmap stage engages (bitmap or
auto mode with at least one multi-block candidate), stats additionally
carry ``block_pairs_bitmap_killed`` (pairs the cell-exact stage proved
dead) and ``bitmap_build_s`` (its wall-clock, also traced as a
``prep.bitmap`` span); the keys are absent otherwise, so summaries of
workloads that never engage the feature are unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.backend.artifacts import ChunkView, JoinArtifactCache, task_coords
from repro_torch.kernels.simjoin import ops, prune as prune_mod, simjoin
from repro_torch.obs.trace import NULL_TRACER

JOIN_BACKENDS = ("numpy", "torch")
PRUNE_MODES = ("dense", "block", "bitmap", "auto")

# One unit of join work: (node, a side, b side, self-join?). Each side is
# a (n, d) coordinate array or a ChunkView wrapping one (see
# repro_torch.backend.artifacts.task_coords).
JoinTask = Tuple[int, np.ndarray, np.ndarray, bool]


@dataclasses.dataclass
class PreparedBatch:
    """One shape bucket's stacked kernel inputs, ready for dispatch.

    ``arrays`` is ``(a_stack, b_stack)`` for the dense grid or
    ``(a_stack, b_stack, pairs_stack)`` for the block-sparse grid, as
    host numpy arrays; ``fn_key`` identifies the entry point + shape
    bucket. The device backend uploads ``arrays`` to ``node``'s device
    before dispatch; ``node`` is ``None`` for node-agnostic bucketing."""

    node: Optional[int]
    same: bool
    idxs: List[int]
    arrays: Tuple[np.ndarray, ...]
    fn_key: tuple


def count_similar_pairs_np(a: np.ndarray, b: np.ndarray, eps: int,
                           same: bool, block: int = 256) -> int:
    """Unordered (x != y) L1-neighbor pairs between cell coordinate sets.
    Blocked to bound memory; numpy reference executor. The distance is
    summed one dimension at a time in int64 over cache-sized blocks, a
    self-join skips the blocks wholly below the diagonal, and hits are
    counted with ``count_nonzero``: the reference's counts, several
    times faster than its one-expression form over 4096-row blocks."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0
    total = 0
    for i0 in range(0, a.shape[0], block):
        ai = a[i0:i0 + block].astype(np.int64)
        for j0 in range(0, b.shape[0], block):
            if same and j0 + block <= i0:
                continue            # every (i, j) here has j < i
            bj = b[j0:j0 + block].astype(np.int64)
            dist = np.abs(ai[:, None, 0] - bj[None, :, 0])
            for k in range(1, ai.shape[1]):
                dist += np.abs(ai[:, None, k] - bj[None, :, k])
            hit = dist <= eps
            if same:
                # Count each unordered pair once; drop identical cells.
                ii = i0 + np.arange(ai.shape[0])[:, None]
                jj = j0 + np.arange(bj.shape[0])[None, :]
                hit &= ii < jj
            total += int(np.count_nonzero(hit))
    return total


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host stack on ``device``: through pinned host memory with a
    non-blocking copy on the card, a plain ``torch.from_numpy`` view on
    the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def bucket_by_shape(tasks: Sequence[JoinTask], block: int,
                    by_node: bool = False) -> Dict[tuple, List[int]]:
    """Group non-empty tasks into batched-dispatch buckets keyed by
    self-join mode and BLOCK-padded coordinate-set shapes (plus the
    executing node when ``by_node`` — the mesh backend pins each bucket
    to its node's device). Returns key -> task indices."""
    buckets: Dict[tuple, List[int]] = {}
    for i, (node, a, b, same) in enumerate(tasks):
        ca, cb = task_coords(a), task_coords(b)
        if ca.shape[0] == 0 or cb.shape[0] == 0:
            continue
        na = -(-ca.shape[0] // block) * block
        nb = -(-cb.shape[0] // block) * block
        key = (node, same, na, nb) if by_node else (same, na, nb)
        buckets.setdefault(key, []).append(i)
    return buckets


class NumpyJoinExecutor:
    """Reference executor: evaluate each pair independently."""

    # The fault points a join round through this executor crosses, in
    # order (the backends arm them — with retry — before dispatching;
    # see ``SimulatedBackend._arm_join_points``). The numpy reference
    # has no host-prep stage to fail, only the dispatch itself.
    fault_points = ("dispatch.kernel",)

    def __init__(self, join_fn: Callable[..., int]):
        self.join_fn = join_fn
        # Block-pair counters are a kernel-path concept; the numpy
        # reference has none (ExecutedQuery fields stay None).
        self.last_stats: Optional[Dict[str, int]] = None
        # Backends swap in a live tracer at bind time (telemetry on).
        self.tracer = NULL_TRACER

    def count_pairs(self, tasks: Sequence[JoinTask], eps: int) -> List[int]:
        """Per-task match counts via the (overridable) numpy predicate
        (ChunkView task sides are unwrapped to the raw arrays the
        predicate expects)."""
        with self.tracer.span("dispatch", tasks=len(tasks)):
            return [self.join_fn(task_coords(a), task_coords(b), eps, same)
                    for _, a, b, same in tasks]


class TorchJoinExecutor:
    """Batched executor over the ``kernels/simjoin`` CUDA kernels.

    Each node's chunk-pair tasks are padded to BLOCK and bucketed by
    padded shape and self-join mode; each bucket is dispatched as ONE
    stacked kernel launch — turning a pair-at-a-time python loop into a
    handful of launches per query. Buckets span nodes because the
    simulated backend executes every node's work on this one device; the
    device backend (``repro_torch.backend.torch_device``) keys buckets by
    node and places each bucket on that node's device.

    ``prune`` selects the grid: ``"dense"`` (full grid — parity
    reference), ``"block"`` (always block-sparse: per task the
    coordinates are spatially sorted, live block pairs computed on host,
    and the pair list — padded to a power-of-two bucket length — handed
    to the pair-list kernel), ``"bitmap"`` (block-sparse with the
    cell-exact second stage: hierarchical occupancy bitmaps kill
    bbox-surviving pairs whose occupied cells are provably > eps apart
    before the list is padded), or ``"auto"`` (default: per task,
    block-sparse only when the padded *bitmap-refined* pair list is
    shorter than the dense grid).

    ``device`` is where :meth:`dispatch` uploads host batches (the card
    by default; ``"cpu"`` runs the plain PyTorch versions) and ``impl``
    (``"kernel"`` / ``"plain"``) is handed to the kernel wrappers.

    Host-side prep is memoized in :attr:`artifacts` (a
    :class:`~repro_torch.backend.artifacts.JoinArtifactCache`) for tasks
    whose sides are :class:`~repro_torch.backend.artifacts.ChunkView`
    handles — the backends attach them so repeated queries over resident
    chunks skip sort/box/pad/pair-list work entirely; ``last_stats``
    records the per-query ``prep_s``/``dispatch_s`` split and artifact
    hit/miss deltas alongside the block-pair counters.
    """

    # A join round through this executor has two failure-prone stages:
    # the host-side batch build and the kernel dispatch. The backends
    # arm these fault points (with retry) before the round — re-arming
    # without re-running is a faithful redo since both are pure.
    fault_points = ("prep.build", "dispatch.kernel")

    def __init__(self, device="cuda", impl: str = "kernel",
                 prune: str = "auto",
                 artifacts: Optional[JoinArtifactCache] = None):
        if prune not in PRUNE_MODES:
            raise ValueError(f"unknown prune mode {prune!r}; "
                             f"known: {PRUNE_MODES}")
        if impl not in simjoin.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; "
                             f"known: {simjoin.IMPLS}")
        self._ops = ops
        self._prune = prune_mod
        self._block = simjoin.BLOCK
        self._sentinel = simjoin.SENTINEL
        self.device = ops.resolve_device(device)
        self.impl = impl
        self.prune = prune
        self.artifacts = (artifacts if artifacts is not None
                          else JoinArtifactCache())
        self.last_stats: Optional[Dict[str, int]] = None
        # Backends swap in a live tracer at bind time (telemetry on);
        # prep/dispatch spans bracket the host-side batch build and the
        # kernel-dispatch loop respectively.
        self.tracer = NULL_TRACER

    # ------------------------------------------------ artifact-aware prep

    def _sorted_side(self, x) -> np.ndarray:
        """Spatially sorted coordinates of one task side (artifact-cached
        for ChunkViews, computed in place for raw arrays)."""
        if isinstance(x, ChunkView) and x.key is not None:
            return self.artifacts.sorted_coords(
                x, lambda: self._prune.spatial_sort(x.coords))
        return self._prune.spatial_sort(task_coords(x))

    def _padded_side(self, x, sentinel: int,
                     sorted_arr: Optional[np.ndarray] = None) -> np.ndarray:
        """Sentinel-padded coordinate-major form of one task side.
        ChunkViews cache the padded *sorted* artifact (shared across
        dense and block dispatch — the count is invariant under the
        reordering); raw arrays pad ``sorted_arr`` when the caller
        pre-sorted them (block path) and the original order otherwise
        (dense path, the seed behavior)."""
        if isinstance(x, ChunkView) and x.key is not None:
            return self.artifacts.padded(
                x, sentinel,
                lambda: self._ops.pad_cm_np(self._sorted_side(x), sentinel))
        base = sorted_arr if sorted_arr is not None else task_coords(x)
        return self._ops.pad_cm_np(base, sentinel)

    def _pair_list(self, xa, xb, a_s: np.ndarray, b_s: np.ndarray,
                   eps: int, same: bool) -> Tuple[np.ndarray, int]:
        """The task's ``(pairs, dense_total)`` block-pair list
        (artifact-cached per chunk pair + eps when both sides are
        cacheable views)."""
        return self.artifacts.block_pairs(
            xa, xb, self._block, int(eps), bool(same),
            lambda: self._prune.build_block_pairs(
                a_s, b_s, self._block, int(eps), bool(same)))

    def _bitmaps(self, x, sorted_arr: np.ndarray, scale: int) -> list:
        """One task side's hierarchical occupancy bitmaps
        (artifact-cached per block size + quantization scale for
        ChunkViews, computed in place for raw arrays)."""
        if isinstance(x, ChunkView) and x.key is not None:
            return self.artifacts.bitmaps(
                x, self._block, scale,
                lambda: self._prune.build_bitmaps(
                    sorted_arr, self._block, scale))
        return self._prune.build_bitmaps(sorted_arr, self._block, scale)

    def _refined_pairs(self, xa, xb, a_s: np.ndarray, b_s: np.ndarray,
                       pairs: np.ndarray, eps: int, same: bool
                       ) -> Tuple[np.ndarray, int]:
        """The task's ``(refined_pairs, killed)`` after the cell-exact
        bitmap stage (artifact-cached like the bbox pair list; warm
        queries skip both the bitmap build and the intersection pass)."""
        scale = self._prune.bitmap_scale(eps)

        def compute():
            bm_a = self._bitmaps(xa, a_s, scale)
            bm_b = bm_a if same else self._bitmaps(xb, b_s, scale)
            return self._prune.refine_block_pairs(
                pairs, bm_a, bm_b, int(eps), scale)

        return self.artifacts.refined_pairs(
            xa, xb, self._block, int(eps), bool(same), compute)

    # ------------------------------------------------- batch preparation

    def iter_batches(self, tasks: Sequence[JoinTask], eps: int,
                     by_node: bool = False
                     ) -> Tuple[List[PreparedBatch], Dict[str, int]]:
        """Bucket and stack the tasks' kernel inputs (dense, block, or
        per-task auto-selected per the ``prune`` knob); returns
        ``(batches, stats)`` where stats carries the query's
        ``block_pairs_total`` / ``_evaluated``, the host-side ``prep_s``
        wall-clock, and the artifact-cache hit/miss deltas."""
        t0 = time.perf_counter()
        h0, m0 = self.artifacts.hits, self.artifacts.misses
        with self.tracer.span("prep", tasks=len(tasks)):
            if self.prune == "dense":
                batches, stats = self._batches_dense(tasks, by_node)
            else:
                batches, stats = self._batches_block(
                    tasks, eps, by_node, auto=self.prune == "auto",
                    bitmap=self.prune in ("bitmap", "auto"))
        stats["prep_s"] = time.perf_counter() - t0
        stats["artifact_hits"] = self.artifacts.hits - h0
        stats["artifact_misses"] = self.artifacts.misses - m0
        return batches, stats

    def _stack_dense(self, tasks: Sequence[JoinTask], idxs: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad one dense bucket's coordinate sets to BLOCK (±sentinel
        fill) and stack them into the (k, d, N) batches the batched
        kernel consumes."""
        a_stack = np.stack([self._padded_side(tasks[i][1], self._sentinel)
                            for i in idxs])
        b_stack = np.stack([self._padded_side(tasks[i][2], -self._sentinel)
                            for i in idxs])
        return a_stack, b_stack

    def _batches_dense(self, tasks: Sequence[JoinTask], by_node: bool
                       ) -> Tuple[List[PreparedBatch], Dict[str, int]]:
        """Dense grid: every block pair of every bucketed task runs."""
        batches: List[PreparedBatch] = []
        total = 0
        for key, idxs in bucket_by_shape(tasks, self._block,
                                         by_node=by_node).items():
            node = key[0] if by_node else None
            same, na, nb = key[-3:]
            a_stack, b_stack = self._stack_dense(tasks, idxs)
            total += (na // self._block) * (nb // self._block) * len(idxs)
            batches.append(PreparedBatch(
                node=node, same=same, idxs=list(idxs),
                arrays=(a_stack, b_stack),
                fn_key=("dense", same, na, nb)))
        return batches, {"block_pairs_total": total,
                         "block_pairs_evaluated": total}

    def _batches_block(self, tasks: Sequence[JoinTask], eps: int,
                       by_node: bool, auto: bool = False,
                       bitmap: bool = False
                       ) -> Tuple[List[PreparedBatch], Dict[str, int]]:
        """Block-sparse grid: sort, prune, and pad each task's pair
        list; tasks with no surviving block pair skip dispatch (their
        count is provably zero). With ``bitmap``, bbox-surviving pair
        lists pass a second, cell-exact refinement stage (hierarchical
        occupancy bitmaps, ``prune.refine_block_pairs``) before routing
        — run as a distinct ``prep.bitmap`` phase so its wall-clock and
        killed-pair counters are attributable. With ``auto``, a task
        whose padded (refined) pair list cannot beat its dense grid is
        routed to a dense bucket instead — single-block chunk pairs skip
        pair-list construction entirely (a dense grid of one block is
        already minimal)."""
        total = evaluated = killed = 0
        prepped: Dict[int, tuple] = {}
        block_buckets: Dict[tuple, List[int]] = {}
        dense_buckets: Dict[tuple, List[int]] = {}
        # Phase 1 — bbox prune: sorted sides + live block-pair lists.
        cand: List[tuple] = []
        for i, (node, a, b, same) in enumerate(tasks):
            ca, cb = task_coords(a), task_coords(b)
            if ca.shape[0] == 0 or cb.shape[0] == 0:
                continue
            na = -(-ca.shape[0] // self._block) * self._block
            nb = -(-cb.shape[0] // self._block) * self._block
            grid = (na // self._block) * (nb // self._block)
            dkey = ((node,) if by_node else ()) + (same, na, nb)
            if auto and grid == 1:
                total += 1
                evaluated += 1
                dense_buckets.setdefault(dkey, []).append(i)
                continue
            a_s = self._sorted_side(a)
            b_s = a_s if same else self._sorted_side(b)
            pairs, dense_total = self._pair_list(a, b, a_s, b_s, eps, same)
            total += dense_total
            if pairs.shape[0] == 0:
                continue
            cand.append((i, dkey, a, b, a_s, b_s, same, pairs, dense_total))
        # Phase 2 — cell-exact refinement of every bbox survivor (the
        # stats keys appear iff this stage actually ran on a candidate,
        # so workloads that never engage it keep seed-shaped stats).
        bitmap_s = None
        if bitmap and cand:
            tb = time.perf_counter()
            with self.tracer.span("prep.bitmap", candidates=len(cand)):
                refined_cand = []
                for (i, dkey, a, b, a_s, b_s, same, pairs,
                     dense_total) in cand:
                    pairs, k = self._refined_pairs(
                        a, b, a_s, b_s, pairs, eps, same)
                    killed += k
                    refined_cand.append(
                        (i, dkey, a_s, b_s, pairs, dense_total))
                cand = refined_cand
            bitmap_s = time.perf_counter() - tb
        else:
            cand = [(i, dkey, a_s, b_s, pairs, dense_total)
                    for (i, dkey, a, b, a_s, b_s, same, pairs,
                         dense_total) in cand]
        # Phase 3 — routing: fully-killed tasks skip dispatch (their
        # count is provably zero); auto compares the padded refined
        # length against the dense grid.
        for (i, dkey, a_s, b_s, pairs, dense_total) in cand:
            if pairs.shape[0] == 0:
                continue
            if (auto and self._prune.padded_pair_len(pairs.shape[0])
                    >= dense_total):
                evaluated += dense_total
                dense_buckets.setdefault(dkey, []).append(i)
                continue
            evaluated += pairs.shape[0]
            plen = self._prune.padded_pair_len(pairs.shape[0])
            prepped[i] = (a_s, b_s, pairs)
            block_buckets.setdefault(dkey + (plen,), []).append(i)
        batches: List[PreparedBatch] = []
        for key, idxs in block_buckets.items():
            node = key[0] if by_node else None
            same, na, nb, plen = key[-4:]
            a_stack = np.stack([self._padded_side(tasks[i][1], self._sentinel,
                                                  sorted_arr=prepped[i][0])
                                for i in idxs])
            b_stack = np.stack([self._padded_side(tasks[i][2],
                                                  -self._sentinel,
                                                  sorted_arr=prepped[i][1])
                                for i in idxs])
            p_stack = np.stack([self._prune.pad_pairs(prepped[i][2], plen)
                                for i in idxs])
            # The lists' range check, once per prepared batch on the
            # host: the kernel path reads nothing back from the card.
            simjoin.check_pairs_in_grid(p_stack, na // self._block,
                                        nb // self._block)
            batches.append(PreparedBatch(
                node=node, same=same, idxs=list(idxs),
                arrays=(a_stack, b_stack, p_stack),
                fn_key=("block", same, na, nb, plen)))
        for key, idxs in dense_buckets.items():
            node = key[0] if by_node else None
            same, na, nb = key[-3:]
            a_stack, b_stack = self._stack_dense(tasks, idxs)
            batches.append(PreparedBatch(
                node=node, same=same, idxs=list(idxs),
                arrays=(a_stack, b_stack),
                fn_key=("dense", same, na, nb)))
        stats = {"block_pairs_total": total,
                 "block_pairs_evaluated": evaluated}
        if bitmap_s is not None:
            stats["block_pairs_bitmap_killed"] = killed
            stats["bitmap_build_s"] = bitmap_s
        return batches, stats

    # ---------------------------------------------------------- dispatch

    def dispatch(self, batch: PreparedBatch, eps: int,
                 arrays: Optional[tuple] = None) -> torch.Tensor:
        """Run one prepared batch through its kernel; returns the (k,)
        per-task int32 match counts on the batch's device (not yet
        synchronized). ``arrays`` overrides ``batch.arrays`` with
        device-placed tensors (the device backend places them on the
        executing node's device first); otherwise the host stacks are
        uploaded to :attr:`device`."""
        if arrays is None:
            arrays = tuple(upload(x, self.device) for x in batch.arrays)
        fn = (self._ops.count_similar_pairs_batch
              if batch.fn_key[0] == "dense"
              else self._ops.count_similar_pairs_pruned_batch)
        return fn(*arrays, eps=int(eps), same=batch.same,
                  device=arrays[0].device, impl=self.impl)

    def count_pairs(self, tasks: Sequence[JoinTask], eps: int) -> List[int]:
        """Per-task match counts via bucketed batched kernel dispatch;
        records the query's block-pair counters, prep/dispatch split,
        and artifact hit/miss deltas in ``last_stats``."""
        counts = [0] * len(tasks)
        batches, stats = self.iter_batches(tasks, eps)
        t0 = time.perf_counter()
        with self.tracer.span("dispatch", batches=len(batches)):
            for batch in batches:
                got = self.dispatch(batch, eps).cpu().numpy()
                for i, c in zip(batch.idxs, got):
                    counts[i] = int(c)
        stats["dispatch_s"] = time.perf_counter() - t0
        self.last_stats = stats
        return counts


def make_join_executor(backend: str, join_fn: Callable[..., int],
                       device="cuda", impl: str = "kernel",
                       prune: str = "auto",
                       artifacts: Optional[JoinArtifactCache] = None):
    """Build a join executor for ``backend`` (``"numpy"`` or ``"torch"``;
    nothing degrades to another executor). ``prune`` selects the torch
    grid (``"dense"`` full grid / ``"block"`` block-sparse / ``"bitmap"``
    block-sparse + cell-exact refinement / ``"auto"`` per-task selection,
    the default); the numpy executor has no block structure, so it
    accepts the adaptive default as a no-op but rejects an explicit
    ``"block"`` or ``"bitmap"`` request it cannot honor. ``device`` and
    ``impl`` configure the torch executor."""
    if backend == "numpy":
        if prune in ("block", "bitmap"):
            raise ValueError(
                f"prune={prune!r} requires the torch join backend; the "
                f"numpy executor has no block grid to prune")
        return NumpyJoinExecutor(join_fn)
    if backend == "torch":
        return TorchJoinExecutor(device=device, impl=impl, prune=prune,
                                 artifacts=artifacts)
    raise ValueError(f"unknown join backend {backend!r}; "
                     f"known: {JOIN_BACKENDS}")

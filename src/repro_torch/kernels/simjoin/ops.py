"""Entry points around the simjoin kernels: padding, sentinel injection,
block-count reduction, numpy-friendly entry points usable as
``RawArrayCluster.join_fn``, and the pruned (block-sparse) variants fed
by the host-side ``repro_torch.kernels.simjoin.prune`` preprocessing.

The port of ``repro/kernels/simjoin/ops.py``, with the same entry points,
signatures and results. Each takes a ``device`` (the card by default;
``"cpu"`` runs the plain PyTorch versions) and an ``impl``
(``"kernel"``, or ``"plain"`` to run the plain version on the card — the
counterpart of the reference's ``interpret=True``). PyTorch runs eagerly,
so the reference's jit trace counter ``TRACE_COUNTS`` has no counterpart
here; the kernels' launch counts live in ``simjoin.LAUNCHES``."""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.simjoin.simjoin import (BLOCK, SENTINEL,
                                                 check_pairs_in_grid,
                                                 simjoin_block_counts,
                                                 simjoin_pruned_block_counts)

DeviceLike = Union[str, torch.device]
ArrayLike = Union[np.ndarray, torch.Tensor]


def resolve_device(device: DeviceLike) -> torch.device:
    """The ``torch.device`` an entry point runs on. ``"cuda"`` needs a
    card (raises ``RuntimeError`` without one — nothing falls back to the
    CPU) and gains the current device index; ``"cpu"`` runs the plain
    versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def _to_int32(x: ArrayLike, device: torch.device) -> torch.Tensor:
    """``x`` as an int32 tensor on ``device`` (the reference's
    ``jnp.asarray(x, jnp.int32)``)."""
    return torch.as_tensor(x).to(device=device, dtype=torch.int32)


def _pad_cm(x: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(N, d) -> coordinate-major (d, N_padded) int32 with sentinel fill
    (one whole BLOCK of sentinels when N == 0)."""
    n, d = x.shape
    npad = (-n) % BLOCK
    xt = x.to(torch.int32).t()
    if npad or n == 0:
        pad_n = npad if n else BLOCK
        xt = torch.cat([xt, torch.full((d, pad_n), sentinel,
                                       dtype=torch.int32, device=x.device)],
                       dim=1)
    return xt.contiguous()


def count_similar_pairs(a: ArrayLike, b: ArrayLike, eps: int, same: bool,
                        device: DeviceLike = "cuda",
                        impl: str = "kernel") -> torch.Tensor:
    """Unordered L1-neighbor pair count between (N, d) coordinate sets
    (see ``ref.count_pairs_ref``); a 0-d int32 tensor on ``device``."""
    dev = resolve_device(device)
    at = _pad_cm(_to_int32(a, dev), SENTINEL)
    bt = _pad_cm(_to_int32(b, dev), -SENTINEL)
    counts = simjoin_block_counts(at[None], bt[None], eps, same, impl=impl)
    return counts.sum(dtype=torch.int32)


def count_similar_pairs_np(a: np.ndarray, b: np.ndarray, eps: int,
                           same: bool, device: DeviceLike = "cuda",
                           impl: str = "kernel") -> int:
    """Drop-in ``join_fn`` for repro_torch.core.cluster.RawArrayCluster."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0
    return int(count_similar_pairs(a, b, int(eps), bool(same),
                                   device=device, impl=impl))


def pad_cm_np(x: np.ndarray, sentinel: int) -> np.ndarray:
    """Host-side version of ``_pad_cm``: (N, d) int coords -> coordinate-
    major (d, N_padded) int32 with sentinel fill, N_padded a positive
    multiple of BLOCK. Used to stack shape-bucketed pair batches before a
    single device transfer."""
    n, d = x.shape
    pad_n = (-n) % BLOCK if n else BLOCK
    xt = np.ascontiguousarray(x.astype(np.int32, copy=False).T)
    if pad_n:
        xt = np.pad(xt, ((0, 0), (0, pad_n)), constant_values=sentinel)
    return xt


def count_similar_pairs_batch(a_stack: ArrayLike, b_stack: ArrayLike,
                              eps: int, same: bool,
                              device: DeviceLike = "cuda",
                              impl: str = "kernel") -> torch.Tensor:
    """Batched pair counting: ``a_stack``/``b_stack`` are (k, d, Na) /
    (k, d, Nb) coordinate-major stacks (pre-padded to BLOCK multiples with
    sentinels, e.g. via :func:`pad_cm_np`). Returns (k,) int32 match
    counts — one kernel launch per shape bucket, the batch on the grid's
    third axis, each task's grid (and self-join masking) identical to the
    unbatched call."""
    dev = resolve_device(device)
    counts = simjoin_block_counts(_to_int32(a_stack, dev),
                                  _to_int32(b_stack, dev), eps, same,
                                  impl=impl)
    return counts.sum(dim=(1, 2), dtype=torch.int32)


def _check_host_pairs(a: ArrayLike, b: ArrayLike, pairs: ArrayLike) -> None:
    """The range check of a pair list that arrives as numpy, on the host
    before upload (the kernel path does not read the list back). On the
    plain route the plain version checks the same list once more; that
    second check is kept, as it guards direct calls of the plain version."""
    if isinstance(pairs, np.ndarray):
        check_pairs_in_grid(pairs, a.shape[-1] // BLOCK,
                            b.shape[-1] // BLOCK)


def count_similar_pairs_pruned(a_cm: ArrayLike, b_cm: ArrayLike,
                               pairs: ArrayLike, eps: int, same: bool,
                               device: DeviceLike = "cuda",
                               impl: str = "kernel") -> torch.Tensor:
    """Block-sparse pair counting for ONE coordinate-set pair:
    ``a_cm``/``b_cm`` are (d, N) coordinate-major sets already spatially
    sorted and sentinel-padded on host (``prune.spatial_sort`` +
    :func:`pad_cm_np`), ``pairs`` the (P, 3) live block-pair list from
    ``prune.build_block_pairs``. Returns the 0-d int32 match count."""
    dev = resolve_device(device)
    _check_host_pairs(a_cm, b_cm, pairs)
    counts = simjoin_pruned_block_counts(
        _to_int32(a_cm, dev)[None], _to_int32(b_cm, dev)[None],
        _to_int32(pairs, dev)[None], eps, same, impl=impl)
    return counts.sum(dtype=torch.int32)


def count_similar_pairs_pruned_batch(a_stack: ArrayLike, b_stack: ArrayLike,
                                     pairs_stack: ArrayLike, eps: int,
                                     same: bool, device: DeviceLike = "cuda",
                                     impl: str = "kernel") -> torch.Tensor:
    """Batched block-sparse pair counting: (k, d, Na) / (k, d, Nb)
    coordinate-major stacks plus a (k, P, 3) pair-list stack (every
    element's live pairs padded to the bucket's P with ``valid == 0``
    rows, see ``prune.pad_pairs``). Returns (k,) int32 match counts."""
    dev = resolve_device(device)
    _check_host_pairs(a_stack, b_stack, pairs_stack)
    counts = simjoin_pruned_block_counts(
        _to_int32(a_stack, dev), _to_int32(b_stack, dev),
        _to_int32(pairs_stack, dev), eps, same, impl=impl)
    return counts.sum(dim=1, dtype=torch.int32)


def count_similar_pairs_pruned_np(a: np.ndarray, b: np.ndarray, eps: int,
                                  same: bool, device: DeviceLike = "cuda",
                                  impl: str = "kernel"
                                  ) -> Tuple[int, int, int]:
    """Full host pipeline for one pair — sort, prune, pad, dispatch —
    returning ``(match_count, block_pairs_total, block_pairs_evaluated)``
    where *total* is the dense kernel's grid size and *evaluated* the
    live pairs actually dispatched. Used by benchmarks and parity tests;
    the batched executor path lives in ``repro_torch.backend.executors``."""
    from repro_torch.kernels.simjoin import prune
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0, 0, 0
    a_s = prune.spatial_sort(np.asarray(a))
    b_s = a_s if same else prune.spatial_sort(np.asarray(b))
    pairs, total = prune.build_block_pairs(a_s, b_s, BLOCK, int(eps),
                                           bool(same))
    if pairs.shape[0] == 0:
        return 0, total, 0
    at = pad_cm_np(a_s, SENTINEL)
    bt = pad_cm_np(b_s, -SENTINEL)
    got = count_similar_pairs_pruned(at, bt, pairs, int(eps), bool(same),
                                     device=device, impl=impl)
    return int(got), total, int(pairs.shape[0])

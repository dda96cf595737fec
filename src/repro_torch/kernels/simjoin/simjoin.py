"""Blocked L1 similarity-join kernels: hand-written CUDA for Hopper plus
their plain PyTorch versions.

The port of ``repro/kernels/simjoin/simjoin.py``. Two CUDA kernels in
``simjoin.cu`` replace the two Pallas TPU kernels:

  * :func:`simjoin_block_counts` — the dense grid (``simjoin_block_counts``
    of the reference): every ``(Na/128, Nb/128)`` block pair of each
    stacked task is evaluated;
  * :func:`simjoin_pruned_block_counts` — the block-sparse grid
    (``simjoin_pruned_block_counts`` of the reference): only the rows of
    a host-built ``(k, P, 3)`` list of ``(block_i, block_j, valid)``
    pairs (``repro_torch.kernels.simjoin.prune``) are evaluated.

Both take coordinate-major int32 stacks ``(k, d, N)``, ``N`` a multiple
of :data:`BLOCK`, padded with ``+SENTINEL`` (a side) / ``-SENTINEL``
(b side) so pad cells never match, and return per-block-pair int32
counts. Self-join mode counts only global ``i < j``.

Each wrapper launches its kernel for a CUDA tensor and counts the launch
in :data:`LAUNCHES`; for a CPU tensor, or under ``impl="plain"``, it runs
the plain PyTorch version beside it (``*_plain``), which repeats the
kernel's int32 arithmetic block pair by block pair. There is no fallback
between the two: a kernel that fails to build or launch raises.

On the kernel path a wrapper checks only shapes, types, devices and
contiguity, which need nothing from the card, so it never waits for the
device and can be captured in a CUDA graph. The range check of a pair
list (every live row inside the grid) runs on the host, where the list is
built: :func:`check_pairs_in_grid`, called by the executor once per
prepared batch and by ``ops`` for numpy lists. A live row outside the
grid that reaches the kernel anyway traps it (the fault surfaces at the
next synchronize); the plain version raises ``ValueError`` for it.

The kernels are compiled from ``simjoin.cu`` with ``nvcc`` for
``sm_90a`` at their first CUDA call by ``repro_torch.kernels._build``
(a shared library with a plain C interface in
``build/repro_torch_ext/``, loaded through ``ctypes``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary

BLOCK = 128
SENTINEL = 1 << 20

#: A tile pair whose coordinates all lie within +-FP32_EXACT_LIMIT runs
#: the kernels' float32 branch: each |a - b| <= 2^22 and a sum of d <= 4
#: of them <= 2^24, integers that float32 holds exactly. Any other tile
#: pair runs the int32 branch. Both give the plain version's counts.
FP32_EXACT_LIMIT = 1 << 21

#: ``impl`` values: ``"kernel"`` launches the CUDA kernel for CUDA tensors
#: (the plain version serves CPU tensors); ``"plain"`` always runs the
#: plain PyTorch version, on whatever device the tensors are on.
IMPLS = ("kernel", "plain")

#: Kernel name -> launches so far (bumped only where a kernel launches).
LAUNCHES: Dict[str, int] = {"simjoin_block_counts": 0,
                            "simjoin_pruned_block_counts": 0}

SOURCE = Path(__file__).with_name("simjoin.cu")

# Bound on the int32 elements one plain-version step materializes (the
# (cells x cells) distance tile), so large chunk pairs run in slices.
_PLAIN_STEP_ELEMS = 1 << 25

#: The compiled ``simjoin.cu``: its two launchers.
LIBRARY = CudaLibrary("simjoin", SOURCE, {
    "simjoin_dense_launch": (("ptr", "ptr", "ptr", "i64", "i64", "i64", "i64",
                              "i32", "i32", "ptr"), "i32"),
    "simjoin_pruned_launch": (("ptr", "ptr", "ptr", "ptr", "i64", "i64",
                               "i64", "i64", "i64", "i32", "i32", "ptr"),
                              "i32"),
})
#: Facts about the build, filled at first load (see ``CudaLibrary.info``).
BUILD_INFO = LIBRARY.info
#: Compile ``simjoin.cu`` (once per source hash) and load it.
build = LIBRARY.load


# ------------------------------------------------------------ checks


def _check_impl(impl: str) -> None:
    """Reject an unknown ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


def _check_stacks(a: torch.Tensor, b: torch.Tensor) -> None:
    """Shapes and types both kernels take: (k, d, N) int32 stacks, N a
    multiple of BLOCK, one device, and a sentinel distance that
    fits int32 (d * 2^21 < 2^31)."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"expected (k, d, N) stacks, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"expected int32 stacks, got {a.dtype}, {b.dtype}")
    if a.shape[:2] != b.shape[:2]:
        raise ValueError(f"stacks differ in (k, d): {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.shape[2] % BLOCK or b.shape[2] % BLOCK:
        raise ValueError(f"N must be a multiple of {BLOCK}: "
                         f"{a.shape[2]}, {b.shape[2]}")
    if a.device != b.device:
        raise ValueError(f"stacks on different devices: {a.device}, "
                         f"{b.device}")
    if a.shape[1] * (2 * SENTINEL) >= 2 ** 31:
        raise ValueError(f"d={a.shape[1]} overflows the int32 sentinel "
                         f"distance")


def _check_eps(eps: int) -> int:
    """eps as a non-negative int32 threshold."""
    eps = int(eps)
    if not 0 <= eps < 2 ** 31:
        raise ValueError(f"eps={eps} is not a non-negative int32")
    return eps


def _use_kernel(t: torch.Tensor, impl: str) -> bool:
    """True when ``t``'s wrapper must launch the CUDA kernel: a CUDA
    tensor under ``impl="kernel"``. CPU tensors take the plain version;
    any other device raises."""
    _check_impl(impl)
    if t.device.type == "cuda":
        return impl == "kernel"
    if t.device.type == "cpu":
        return False
    raise ValueError(f"simjoin runs on cuda or cpu tensors, not {t.device}")


# ------------------------------------------------------------ plain


def simjoin_block_counts_plain(a: torch.Tensor, b: torch.Tensor, eps: int,
                               same: bool) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel: the same (k, d, Na) /
    (k, d, Nb) int32 stacks in, the same (k, Na/BLOCK, Nb/BLOCK) int32
    per-block-pair counts out, computed in int32 a slice of block rows
    at a time."""
    _check_stacks(a, b)
    eps = _check_eps(eps)
    k, d, na = a.shape
    nb = b.shape[2]
    nab, nbb = na // BLOCK, nb // BLOCK
    out = torch.empty((k, nab, nbb), dtype=torch.int32, device=a.device)
    per_row = BLOCK * nb
    rows = max(1, min(nab, _PLAIN_STEP_ELEMS // per_row))
    tasks = max(1, min(k, _PLAIN_STEP_ELEMS // (per_row * rows))) \
        if rows == nab else 1
    jg = torch.arange(nb, device=a.device)
    for t0 in range(0, k, tasks):
        t1 = min(k, t0 + tasks)
        for i0 in range(0, nab, rows):
            i1 = min(nab, i0 + rows)
            ai = a[t0:t1, :, i0 * BLOCK:i1 * BLOCK]
            bt = b[t0:t1]
            dist = torch.zeros((t1 - t0, ai.shape[2], nb), dtype=torch.int32,
                               device=a.device)
            for c in range(d):
                dist += (ai[:, c, :, None] - bt[:, c, None, :]).abs()
            hit = dist <= eps
            if same:
                ig = torch.arange(i0 * BLOCK, i1 * BLOCK, device=a.device)
                hit &= ig[:, None] < jg[None, :]
            out[t0:t1, i0:i1] = hit.view(t1 - t0, i1 - i0, BLOCK, nbb,
                                         BLOCK).sum(dim=(2, 4),
                                                    dtype=torch.int32)
    return out


def simjoin_pruned_block_counts_plain(a: torch.Tensor, b: torch.Tensor,
                                      pairs: torch.Tensor, eps: int,
                                      same: bool) -> torch.Tensor:
    """Plain PyTorch version of the pair-list kernel: (k, d, Na) /
    (k, d, Nb) int32 stacks and a (k, P, 3) int32 ``(block_i, block_j,
    valid)`` stack in, (k, P) int32 per-row counts times ``valid`` out.
    Rows with ``valid == 0`` read block 0 (always in range) and count 0."""
    _check_stacks(a, b)
    _check_pairs(a, b, pairs)
    eps = _check_eps(eps)
    k, d, na = a.shape
    nb = b.shape[2]
    n_pairs = pairs.shape[1]
    dev = a.device
    ab = a.reshape(k, d, na // BLOCK, BLOCK).permute(0, 2, 1, 3)
    bb = b.reshape(k, d, nb // BLOCK, BLOCK).permute(0, 2, 1, 3)
    flat = pairs.reshape(k * n_pairs, 3).to(torch.int64)
    valid = flat[:, 2]
    live = valid != 0
    bi = torch.where(live, flat[:, 0], 0)
    bj = torch.where(live, flat[:, 1], 0)
    task = torch.arange(k, device=dev).repeat_interleave(n_pairs)
    cells = torch.arange(BLOCK, device=dev)
    out = torch.empty(k * n_pairs, dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_STEP_ELEMS // (BLOCK * BLOCK))
    for s0 in range(0, k * n_pairs, step):
        s1 = min(k * n_pairs, s0 + step)
        t, i, j = task[s0:s1], bi[s0:s1], bj[s0:s1]
        at = ab[t, i]                                  # (n, d, BLOCK)
        bt = bb[t, j]
        dist = torch.zeros((s1 - s0, BLOCK, BLOCK), dtype=torch.int32,
                           device=dev)
        for c in range(d):
            dist += (at[:, c, :, None] - bt[:, c, None, :]).abs()
        hit = dist <= eps
        if same:
            gi = i[:, None] * BLOCK + cells[None, :]
            gj = j[:, None] * BLOCK + cells[None, :]
            hit &= gi[:, :, None] < gj[:, None, :]
        out[s0:s1] = (hit.sum(dim=(1, 2), dtype=torch.int32)
                      * valid[s0:s1].to(torch.int32))
    return out.view(k, n_pairs)


def check_pairs_in_grid(pairs: np.ndarray, na_blocks: int,
                        nb_blocks: int) -> None:
    """Host-side range check of a (P, 3) pair list or (k, P, 3) stack:
    raise ``ValueError`` when a live row (``valid != 0``) names a block
    outside the ``na_blocks x nb_blocks`` grid. The kernel path reads
    nothing back from the card, so this runs where the host builds the
    list (the executor's prepared batch, ``ops`` for numpy lists)."""
    p = np.asarray(pairs)
    live = p[..., 2] != 0
    bad = live & ((p[..., 0] < 0) | (p[..., 0] >= na_blocks)
                  | (p[..., 1] < 0) | (p[..., 1] >= nb_blocks))
    if bad.any():
        raise ValueError(f"pair list names a block outside the grid "
                         f"({na_blocks} x {nb_blocks})")


def _check_pair_stack(a: torch.Tensor, pairs: torch.Tensor) -> None:
    """The pair stack the pruned kernel takes: (k, P, 3) int32, P > 0, on
    the stacks' device. Shapes only: nothing is read from the card."""
    if pairs.dim() != 3 or pairs.shape[2] != 3 or pairs.shape[0] != \
            a.shape[0]:
        raise ValueError(f"expected a (k, P, 3) pair stack for k="
                         f"{a.shape[0]}, got {tuple(pairs.shape)}")
    if pairs.shape[1] == 0:
        raise ValueError("empty pair list: skip the kernel call entirely")
    if pairs.dtype != torch.int32:
        raise TypeError(f"expected an int32 pair stack, got {pairs.dtype}")
    if pairs.device != a.device:
        raise ValueError(f"pair stack on {pairs.device}, stacks on "
                         f"{a.device}")


def _check_pairs(a: torch.Tensor, b: torch.Tensor,
                 pairs: torch.Tensor) -> None:
    """The plain version's pair-stack check: :func:`_check_pair_stack`
    plus :func:`check_pairs_in_grid` on a host copy of the list (which
    waits for the device)."""
    _check_pair_stack(a, pairs)
    check_pairs_in_grid(pairs.cpu().numpy(), a.shape[2] // BLOCK,
                        b.shape[2] // BLOCK)


def _check_kernel_shape(d: int, rows: int) -> None:
    """What the CUDA kernels take beyond the stacks: 1 <= d <= 4 and
    fewer than 2^30 rows (block pairs or list rows) per launch."""
    if not 1 <= d <= 4:
        raise ValueError(f"the CUDA simjoin kernels take 1 <= d <= 4, "
                         f"got d={d}")
    if rows >= 2 ** 30:
        raise ValueError(f"{rows} rows in one launch; the kernels take "
                         f"fewer than 2^30")


# ---------------------------------------------------------- wrappers


def simjoin_block_counts(a: torch.Tensor, b: torch.Tensor, eps: int,
                         same: bool, impl: str = "kernel") -> torch.Tensor:
    """Dense grid: (k, d, Na) / (k, d, Nb) int32 stacks (sentinel-padded
    to BLOCK multiples by ``ops``) -> (k, Na/BLOCK, Nb/BLOCK) int32
    per-block-pair match counts. Launches the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors or under ``impl="plain"``."""
    if not _use_kernel(a, impl):
        return simjoin_block_counts_plain(a, b, eps, same)
    _check_stacks(a, b)
    eps = _check_eps(eps)
    k, d, na = a.shape
    nb = b.shape[2]
    _check_kernel_shape(d, k * (na // BLOCK) * (nb // BLOCK))
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((k, na // BLOCK, nb // BLOCK), dtype=torch.int32,
                      device=a.device)
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.simjoin_dense_launch(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), k, d, na, nb, eps,
                                       int(bool(same)), stream)
    LIBRARY.check(err, "simjoin_block_counts")
    LAUNCHES["simjoin_block_counts"] += 1
    return out


def simjoin_pruned_block_counts(a: torch.Tensor, b: torch.Tensor,
                                pairs: torch.Tensor, eps: int, same: bool,
                                impl: str = "kernel") -> torch.Tensor:
    """Block-sparse grid: evaluate ONLY the listed block pairs.
    ``a``/``b``: (k, d, Na) / (k, d, Nb) int32 stacks, spatially sorted
    and sentinel-padded on host (``prune.spatial_sort`` +
    ``ops.pad_cm_np``); ``pairs``: (k, P, 3) int32 ``(block_i, block_j,
    valid)`` rows from ``prune.build_block_pairs`` padded by
    ``prune.pad_pairs``, in any order. Returns (k, P) int32 per-row
    counts times ``valid`` (zero for ``valid == 0`` rows). Launches the
    CUDA kernel on CUDA tensors (the list's range is checked on the host,
    :func:`check_pairs_in_grid`), the plain version on CPU tensors or
    under ``impl="plain"``."""
    if not _use_kernel(a, impl):
        return simjoin_pruned_block_counts_plain(a, b, pairs, eps, same)
    _check_stacks(a, b)
    _check_pair_stack(a, pairs)
    eps = _check_eps(eps)
    k, d, na = a.shape
    nb = b.shape[2]
    n_pairs = pairs.shape[1]
    _check_kernel_shape(d, k * n_pairs)
    a, b, pairs = a.contiguous(), b.contiguous(), pairs.contiguous()
    out = torch.empty((k, n_pairs), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.simjoin_pruned_launch(a.data_ptr(), b.data_ptr(),
                                        pairs.data_ptr(), out.data_ptr(), k,
                                        d, na, nb, n_pairs, eps,
                                        int(bool(same)), stream)
    LIBRARY.check(err, "simjoin_pruned_block_counts")
    LAUNCHES["simjoin_pruned_block_counts"] += 1
    return out

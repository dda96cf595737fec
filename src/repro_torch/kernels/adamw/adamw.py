"""AdamW with global-norm clipping, fused by hand: the CUDA kernels of
``adamw.cu`` for Hopper, as two custom ops, beside their plain PyTorch
version.

No Pallas kernel stands behind this one: ``repro/train/optimizer.py``'s
``adamw_update`` is plain JAX, which XLA fuses on the TPU. Eager PyTorch
runs each elementwise op of the plain version (:mod:`.ref`) as a pass of
its own over device memory, about 25 full-size fp32 passes a leaf; the
kernels read each gradient once for the norm, then read each parameter,
gradient and moment once and write each parameter and moment once.

The ops take lists of plain tensors, one entry a leaf (a placed optimizer
passes each leaf's local shard):

* ``repro_torch::adamw_sum_squares(grads) -> sums``: each leaf's fp32 sum
  of squares, a ``(n_leaves,)`` float32 tensor (:func:`sum_squares`);
* ``repro_torch::adamw_apply(params, grads, m, v, sumsq, count, decay,
  hyper) -> (count, lr, grad_norm)``: the norm ``sqrt(sum(sumsq))``, the
  clip scale, the step count plus one, the learning rate and the bias
  corrections, then every leaf's update in place (:func:`adamw_apply`).

CUDA tensors launch the kernels: per batch of at most ``max_leaves``
leaves of one gradient dtype two for the sums (chunk partials, then each
leaf's sum), then one for the scalars and one per batch of one (param,
grad, moment) dtype triple for the update; :data:`LAUNCHES` counts every
launch under ``"adamw"``. The sums and scalars stay on the device.
CPU tensors run the plain version (:func:`.ref.adamw_ref`); fake
tensors give outputs of the right shapes and dtypes, nothing computed
(so a dry-run sees two ops, which ``launch.op_analysis`` charges the
kernels' work).
There is no fallback between a kernel and its plain version: a kernel
that fails to build or launch raises, and so does a CUDA tensor of a
dtype other than float32 and bfloat16, or a parameter or moment that is
not contiguous.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels._tensors import run_op
from repro_torch.kernels.adamw.ref import HYPER_FIELDS, Hyper, adamw_ref
from repro_torch.kernels.adamw.ref import sum_squares as sum_squares_ref

#: Kernel launches so far (every kernel of this source, under one name).
LAUNCHES: Dict[str, int] = {"adamw": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The compiled ``adamw.cu``: its limits (leaves a launch takes, elements
#: a chunk holds) and launchers.
LIBRARY = CudaLibrary("adamw", Path(__file__).with_name("adamw.cu"), {
    "adamw_limits": (("ptr",), "i32"),
    "adamw_sumsq_launch": (("ptr", "i32", "i32", "ptr", "ptr", "ptr"),
                           "i32"),
    "adamw_finalize_launch": (("ptr", "i32", "ptr", "ptr", "ptr", "ptr",
                               "ptr") + ("f32",) * 7 + ("i32",) * 3
                              + ("ptr",), "i32"),
    "adamw_update_launch": (("ptr", "i32", "i32", "i32", "i32", "ptr")
                            + ("f32",) * 6 + ("ptr",), "i32"),
})


def _limits(lib) -> Tuple[int, int]:
    """(leaves a launch takes, elements a chunk holds), from the
    library."""
    out = np.zeros(2, np.int64)
    lib.adamw_limits(out.ctypes.data)
    return int(out[0]), int(out[1])


def sum_squares(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each gradient's fp32 sum of squares, a ``(len(grads),)`` float32
    tensor on their device (the op ``repro_torch::adamw_sum_squares``)."""
    grads = list(grads)
    if not grads:
        raise ValueError("no gradients")
    return run_op(torch.ops.repro_torch.adamw_sum_squares,
                  _sum_squares_cuda, _sum_squares_plain, grads)


def adamw_apply(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                v: Sequence[torch.Tensor], sumsq: torch.Tensor,
                count: torch.Tensor, decay: Sequence[bool],
                hyper: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step of every leaf in place (the op
    ``repro_torch::adamw_apply``): the gradients clipped by the norm
    ``sqrt(sum(sumsq))``, ``count + 1`` steps' schedule and bias
    corrections, weight decay on the leaves whose ``decay`` is true;
    ``hyper`` holds the :data:`HYPER_FIELDS` of an ``OptimizerConfig``
    (``ref.HYPER_FIELDS``).
    Returns ``(count + 1, lr, grad_norm)`` as new 0-dim tensors."""
    lists = [list(x) for x in (params, grads, m, v)]
    n = len(lists[0])
    if n == 0 or any(len(x) != n for x in lists[1:]) or len(decay) != n:
        raise ValueError(f"need as many grads, moments and decay flags as "
                         f"params (at least one): {[len(x) for x in lists]}"
                         f", {len(decay)}")
    if len(hyper) != len(HYPER_FIELDS):
        raise ValueError(f"hyper holds {HYPER_FIELDS}, got {len(hyper)} "
                         f"values")
    return run_op(torch.ops.repro_torch.adamw_apply, _apply_cuda,
                  _apply_plain, *lists, sumsq, count,
                  [bool(d) for d in decay], [float(h) for h in hyper])


# ------------------------------------------------------- plain versions


def _sum_squares_plain(grads: List[torch.Tensor]) -> torch.Tensor:
    """The op's default kernel: the plain version's per-leaf sums."""
    return sum_squares_ref(grads)


_sum_squares_op = torch.library.custom_op("repro_torch::adamw_sum_squares",
                                          _sum_squares_plain,
                                          mutates_args=())


@_sum_squares_op.register_fake
def _sum_squares_fake(grads):
    """A ``(n,)`` float32 tensor, nothing computed."""
    return grads[0].new_empty((len(grads),), dtype=torch.float32)


def _apply_plain(params: List[torch.Tensor], grads: List[torch.Tensor],
                 m: List[torch.Tensor], v: List[torch.Tensor],
                 sumsq: torch.Tensor, count: torch.Tensor,
                 decay: List[bool], hyper: List[float]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's default kernel: the plain version's scalars and per-leaf
    update."""
    return adamw_ref(params, grads, m, v, sumsq, count, decay,
                     Hyper(*hyper))


_apply_op = torch.library.custom_op("repro_torch::adamw_apply", _apply_plain,
                                    mutates_args=("params", "m", "v"))


@_apply_op.register_fake
def _apply_fake(params, grads, m, v, sumsq, count, decay, hyper):
    """The new count (int32), lr and norm (float32), nothing computed."""
    return (count.new_empty(()), count.new_empty((), dtype=torch.float32),
            count.new_empty((), dtype=torch.float32))


# ------------------------------------------------------------- kernels


def _device(tensors: Sequence[torch.Tensor]) -> torch.device:
    """The one CUDA device of ``tensors``; raises for a tensor of another
    dtype than float32 and bfloat16, or on another device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"AdamW's tensors on different devices: "
                             f"{dev}, {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"the CUDA AdamW kernels take float32 and "
                            f"bfloat16 tensors, got {t.dtype}")
    return dev


def _batches(keys: Sequence, max_leaves: int) -> List[Tuple[object,
                                                            List[int]]]:
    """Leaf indices grouped by key (first seen first, tree order inside),
    each group cut into batches of at most ``max_leaves``."""
    groups: Dict[object, List[int]] = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    return [(key, idx[s:s + max_leaves]) for key, idx in groups.items()
            for s in range(0, len(idx), max_leaves)]


def _table(idx: List[int], g, p=None, m=None, v=None, decay=None
           ) -> np.ndarray:
    """The kernels' (7, n) int64 leaf table of the leaves ``idx``: rows
    g, p, m, v (data pointers, 0 where not given), element counts, slots
    (the leaves' indices) and decay flags."""
    t = np.zeros((7, len(idx)), np.int64)
    for row, ts in enumerate((g, p, m, v)):
        if ts is not None:
            t[row] = [ts[i].data_ptr() for i in idx]
    t[4] = [g[i].numel() for i in idx]
    t[5] = idx
    if decay is not None:
        t[6] = [int(decay[i]) for i in idx]
    return t


def _sum_squares_cuda(grads: List[torch.Tensor]) -> torch.Tensor:
    """Launch the sums of squares on CUDA gradients."""
    dev = _device(grads)
    grads = [g.contiguous() for g in grads]
    lib = LIBRARY.load()
    max_leaves, chunk = _limits(lib)
    sums = torch.empty(len(grads), dtype=torch.float32, device=dev)
    batches = _batches([_DTYPES[g.dtype] for g in grads], max_leaves)
    chunks = [sum(-(-grads[i].numel() // chunk) for i in idx)
              for _, idx in batches]
    partials = torch.empty(max(1, sum(chunks)), dtype=torch.float32,
                           device=dev)
    offset = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for (key, idx), n_chunks in zip(batches, chunks):
            table = _table(idx, grads)
            err = lib.adamw_sumsq_launch(
                table.ctypes.data, len(idx), key,
                partials.data_ptr() + 4 * offset, sums.data_ptr(), stream)
            LIBRARY.check(err, "adamw_sum_squares")
            LAUNCHES["adamw"] += 2
            offset += n_chunks
    return sums


def _apply_cuda(params, grads, m, v, sumsq, count, decay, hyper):
    """Launch the scalars and the update on CUDA tensors."""
    dev = _device([*params, *grads, *m, *v, sumsq])
    if count.device != dev or count.dtype != torch.int32 \
            or count.numel() != 1:
        raise TypeError(f"count must be one int32 on {dev}, got "
                        f"{tuple(count.shape)} {count.dtype} on "
                        f"{count.device}")
    if sumsq.dim() != 1 or sumsq.numel() == 0 \
            or sumsq.dtype != torch.float32:
        raise TypeError(f"sumsq must be a non-empty float32 vector, got "
                        f"{tuple(sumsq.shape)} {sumsq.dtype}")
    for p, g, mm, vv in zip(params, grads, m, v):
        if not (p.numel() == g.numel() == mm.numel() == vv.numel()) \
                or mm.dtype != vv.dtype:
            raise ValueError(f"a leaf's param, grad and moments differ in "
                             f"size or the moments in dtype: {p.shape}, "
                             f"{g.shape}, {mm.shape} {mm.dtype}, "
                             f"{vv.shape} {vv.dtype}")
        if not (p.is_contiguous() and mm.is_contiguous()
                and vv.is_contiguous()):
            raise ValueError("the CUDA AdamW kernel updates contiguous "
                             "parameters and moments in place")
    grads = [g.contiguous() for g in grads]
    sumsq = sumsq.contiguous()
    h = dict(zip(HYPER_FIELDS, hyper))
    warmup, total = int(h["warmup_steps"]), int(h["total_steps"])
    lib = LIBRARY.load()
    max_leaves, _ = _limits(lib)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    lr = torch.empty((), dtype=torch.float32, device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    scal = torch.empty(4, dtype=torch.float32, device=dev)
    keys = [(_DTYPES[p.dtype], _DTYPES[g.dtype], _DTYPES[mm.dtype])
            for p, g, mm in zip(params, grads, m)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adamw_finalize_launch(
            sumsq.data_ptr(), sumsq.numel(), count.data_ptr(),
            count_out.data_ptr(), lr.data_ptr(), gnorm.data_ptr(),
            scal.data_ptr(), h["peak_lr"], h["min_lr"],
            0.5 * (h["peak_lr"] - h["min_lr"]), math.pi, h["b1"], h["b2"],
            h["clip_norm"], warmup, max(warmup, 1), max(total - warmup, 1),
            stream)
        LIBRARY.check(err, "adamw_apply")
        LAUNCHES["adamw"] += 1
        for key, idx in _batches(keys, max_leaves):
            table = _table(idx, grads, params, m, v, decay)
            err = lib.adamw_update_launch(
                table.ctypes.data, len(idx), *key, scal.data_ptr(),
                h["b1"], 1 - h["b1"], h["b2"], 1 - h["b2"], h["eps"],
                h["weight_decay"], stream)
            LIBRARY.check(err, "adamw_apply")
            LAUNCHES["adamw"] += 1
    return count_out, lr, gnorm


_sum_squares_op.register_kernel("cuda")(_sum_squares_cuda)
_apply_op.register_kernel("cuda")(_apply_cuda)

"""AdamW with global-norm clipping, a warmup + cosine schedule, and an
optional bf16 moment policy (the update is still computed in fp32).
CUDA leaves are updated by hand-written kernels
(:mod:`repro_torch.kernels.adamw`), CPU leaves by the plain version,
whose arithmetic (:func:`lr_schedule`, :func:`step_scalars`,
:func:`update_leaf`) lives beside the kernels in
:mod:`repro_torch.kernels.adamw.ref` and takes an ``OptimizerConfig`` as
its settings.

The port of ``repro/train/optimizer.py``, on trees of tensors (nested
dicts and lists, :mod:`repro_torch.train.tree`). :func:`adamw_update`
writes the new parameters and moments into the tensors it is given (the
reference's buffers are donated to its jitted step; here in place spares
a second copy of the moments, 25.7 GB for llama3.2-3b in fp32) and
returns them with a new step count and the metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from repro_torch.kernels.adamw import adamw as adamw_ops
from repro_torch.kernels.adamw.ref import (  # noqa: F401 (lr_schedule)
    HYPER_FIELDS, lr_schedule, step_scalars, sum_squares, update_leaf)
from repro_torch.models.moe import BIAS
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.sharding.local import (is_dtensor, moved_dims,
                                        sum_over_shards, to_local)
from repro_torch.train.tree import Tree, leaves, tree_map, without

#: ``impl`` values of :func:`adamw_update`.
IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Schedule, AdamW and clipping settings; ``state_dtype`` None keeps
    the moments in fp32, ``torch.bfloat16`` halves them."""
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Optional[Any] = None      # None -> fp32; bf16 for XXL


def trainable(params: Tree) -> Tree:
    """The leaves AdamW updates: ``params`` without the routers'
    balancing biases (``models.moe.BIAS``), which the train step moves by
    their own rule."""
    return without(params, (BIAS,))


def adamw_init(params: Tree, cfg: OptimizerConfig) -> Dict[str, Any]:
    """Zero first and second moments shaped (and, for ``DTensor``
    parameters, placed) like :func:`trainable` ``(params)``, in
    ``state_dtype`` or fp32, and an int32 step count of 0."""
    dt = cfg.state_dtype or torch.float32
    params = trainable(params)

    def zeros(p):
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.sum(sum_squares(leaves(tree))))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict[str, Any],
                 cfg: OptimizerConfig, decay_mask: Optional[Tree] = None,
                 telemetry: Telemetry = NULL_TELEMETRY, impl: str = "kernel"
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step after clipping the gradients to ``clip_norm`` by
    their global norm. Each leaf is updated in fp32 and written back in
    its own dtype; weight decay applies to leaves with ``ndim >= 2``
    only, or to those whose entry in ``decay_mask`` (a tree of bools
    shaped like ``params``) is true. ``params`` and the moments are
    updated in place; returns ``(params, {"m", "v", "count"}, {"lr",
    "grad_norm"})``.

    ``impl="kernel"`` updates CUDA leaves with the hand-written kernels
    (:mod:`repro_torch.kernels.adamw.adamw`: one pass over the gradients
    for the norm, one over every leaf for the update; a ``DTensor`` leaf
    is updated on its local shard, its gradient first placed like it, and
    the norm sums the local sums over the mesh dims that shard each
    leaf), and fake leaves (a dry-run) through the same ops. CPU leaves,
    and ``impl="plain"``, take the plain version: the norm, then
    :func:`update_leaf`'s chain of elementwise ops leaf by leaf.

    The update is ``telemetry``'s ``train.optimizer`` span:
    ``optimizer.norm`` (the norm), then ``optimizer.adamw`` (every leaf's
    update); the counter ``optimizer.kernel_elements`` or
    ``optimizer.plain_elements`` adds the elements updated (local
    shards) by the kernels or by the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
    flat = [leaves(t) for t in (params, grads, state["m"], state["v"])]
    decay = [p.ndim >= 2 for p in flat[0]] \
        if decay_mask is None else leaves(decay_mask)
    kernel = impl == "kernel" and (flat[0][0].device.type == "cuda"
                                   or is_in_torch_dispatch_mode())
    with telemetry.tracer.span("train.optimizer"):
        update = _update_kernel if kernel else _update_plain
        count, lr, gnorm = update(*flat, decay, state["count"], cfg,
                                  telemetry.tracer)
    if telemetry.counting:
        telemetry.count("optimizer.kernel_elements" if kernel
                        else "optimizer.plain_elements",
                        sum(to_local(p).numel() for p in flat[0]))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        metrics


def _update_plain(ps, gs, ms, vs, decay, count, cfg, tracer):
    """The plain version over the leaves: (count, lr, norm)."""
    with tracer.span("optimizer.norm"):
        gnorm = global_norm(gs)
    count, lr, scale, bc1, bc2 = step_scalars(cfg, count, gnorm)
    with tracer.span("optimizer.adamw"):
        for p, g, m, v, dk in zip(ps, gs, ms, vs, decay):
            update_leaf(p, g, m, v, dk, scale, lr, bc1, bc2, cfg)
    return count, lr, gnorm


def _update_kernel(ps, gs, ms, vs, decay, count, cfg, tracer):
    """The kernels over the leaves' local shards: (count, lr, norm)."""
    local_g = [_local_grad(g, p) for g, p in zip(gs, ps)]
    with tracer.span("optimizer.norm"):
        sums = sum_over_shards(adamw_ops.sum_squares(local_g), ps)
    with tracer.span("optimizer.adamw"):
        return adamw_ops.adamw_apply(
            [to_local(p) for p in ps], local_g, [to_local(m) for m in ms],
            [to_local(v) for v in vs], sums, count, decay,
            [float(getattr(cfg, f)) for f in HYPER_FIELDS])


def _local_grad(g, p):
    """``g``'s local shard laid out as ``p``'s: a ``DTensor`` gradient is
    placed like its parameter where that moves data, a pending sum then
    reduced in fp32, as the plain version's fp32 arithmetic reduces it."""
    if not is_dtensor(g):
        return g
    dims = moved_dims(g, p)
    if not dims:
        return g.to_local()
    if any(g.placements[d].is_partial() for d in dims):
        g = g.to(torch.float32)
    return g.redistribute(p.device_mesh, p.placements).to_local()

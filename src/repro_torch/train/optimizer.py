"""AdamW with global-norm clipping, a warmup + cosine schedule, and an
optional bf16 moment policy (the update is still computed in fp32).

The port of ``repro/train/optimizer.py``, on trees of tensors (nested
dicts and lists, :mod:`repro_torch.train.tree`). :func:`adamw_update`
writes the new parameters and moments into the tensors it is given (the
reference's buffers are donated to its jitted step; here in place spares
a second copy of the moments, 25.7 GB for llama3.2-3b in fp32) and
returns them with a new step count and the metrics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.train.tree import Tree, leaves, tree_map


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


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr`` at ``total_steps``; fp32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Tree, cfg: OptimizerConfig) -> Dict[str, Any]:
    """Zero first and second moments shaped (and, for ``DTensor``
    parameters, placed) like ``params``, in ``state_dtype`` or fp32, and
    an int32 step count of 0."""
    dt = cfg.state_dtype or torch.float32

    def zeros(p):
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict[str, Any],
                 cfg: OptimizerConfig, decay_mask: Optional[Tree] = None,
                 telemetry: Telemetry = NULL_TELEMETRY
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step after clipping the gradients to ``clip_norm`` by
    their global norm. Each leaf is updated in fp32 and written back in
    its own dtype; weight decay applies to leaves with ``ndim >= 2``
    only, or to those whose entry in ``decay_mask`` (a tree of bools
    shaped like ``params``) is true. ``params`` and the moments are
    updated in place; returns ``(params, {"m", "v", "count"}, {"lr",
    "grad_norm"})``. The update is ``telemetry``'s ``train.optimizer``
    span: ``optimizer.norm`` (the clipping scale), then
    ``optimizer.adamw`` (every leaf's update)."""
    tracer = telemetry.tracer
    with tracer.span("train.optimizer"):
        count = state["count"] + 1
        lr = lr_schedule(cfg, count)
        with tracer.span("optimizer.norm"):
            gnorm = global_norm(grads)
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm,
                                                            min=1e-12),
                                max=1.0)
        count_f = count.to(torch.float32)
        bc1 = 1 - cfg.b1 ** count_f
        bc2 = 1 - cfg.b2 ** count_f
        decay = [p.ndim >= 2 for p in leaves(params)] \
            if decay_mask is None else leaves(decay_mask)
        with tracer.span("optimizer.adamw"):
            for p, g, m, v, dk in zip(leaves(params), leaves(grads),
                                      leaves(state["m"]),
                                      leaves(state["v"]), decay):
                g32 = g.to(torch.float32) * scale
                m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g32
                v32 = v.to(torch.float32) * cfg.b2 + \
                    (1 - cfg.b2) * torch.square(g32)
                step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                p32 = p.to(torch.float32)
                if dk:                  # no decay on norms / biases
                    step = step + cfg.weight_decay * p32
                p.copy_(p32 - lr * step)
                m.copy_(m32)
                v.copy_(v32)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        metrics

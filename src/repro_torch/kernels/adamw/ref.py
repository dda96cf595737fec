"""Plain PyTorch AdamW with global-norm clipping: the arithmetic of
``repro/train/optimizer.py`` as a chain of elementwise ops, the plain
version the CUDA kernels of ``adamw.cu`` are held against, and the update
of leaves the kernels do not take (CPU tensors, ``impl="plain"``).

Every function takes its settings as ``hyper``: any object with the
attributes :data:`HYPER_FIELDS`, an ``OptimizerConfig`` or a
:class:`Hyper` built from the kernel ops' flat list of floats."""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch


class Hyper(NamedTuple):
    """The schedule, AdamW and clipping settings, as the kernel ops take
    them (a flat list of floats in this order)."""
    peak_lr: float
    min_lr: float
    warmup_steps: float
    total_steps: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip_norm: float


#: The settings :class:`Hyper` holds, in order.
HYPER_FIELDS = Hyper._fields


def lr_schedule(hyper, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr`` at ``total_steps``; fp32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = hyper.peak_lr * step / max(hyper.warmup_steps, 1)
    t = (step - hyper.warmup_steps) / max(
        hyper.total_steps - hyper.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = hyper.min_lr + 0.5 * (hyper.peak_lr - hyper.min_lr) * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < hyper.warmup_steps, warm, cos)


def sum_squares(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each gradient's fp32 sum of squares, stacked in order."""
    return torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads])


def step_scalars(hyper, count: torch.Tensor, gnorm: torch.Tensor):
    """The step's 0-dim scalars from the previous step count and the
    global norm: ``(count + 1, lr, clip scale, 1 - b1^count, 1 -
    b2^count)``."""
    count = count + 1
    lr = lr_schedule(hyper, count)
    scale = torch.clamp(hyper.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    count_f = count.to(torch.float32)
    return count, lr, scale, 1 - hyper.b1 ** count_f, \
        1 - hyper.b2 ** count_f


def update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, decay: bool, scale: torch.Tensor,
                lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                hyper) -> None:
    """One leaf's AdamW update in fp32, written back in place in each
    tensor's own dtype."""
    g32 = g.to(torch.float32) * scale
    m32 = m.to(torch.float32) * hyper.b1 + (1 - hyper.b1) * g32
    v32 = v.to(torch.float32) * hyper.b2 + \
        (1 - hyper.b2) * torch.square(g32)
    step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + hyper.eps)
    p32 = p.to(torch.float32)
    if decay:                   # no decay on norms / biases
        step = step + hyper.weight_decay * p32
    p.copy_(p32 - lr * step)
    m.copy_(m32)
    v.copy_(v32)


def adamw_ref(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
              sumsq: torch.Tensor, count: torch.Tensor,
              decay: Sequence[bool], hyper):
    """Every leaf's update in place from the leaves' sums of squares
    ``sumsq`` (the plain version of ``adamw_apply``); returns ``(count +
    1, lr, grad_norm)``."""
    gnorm = torch.sqrt(torch.sum(sumsq))
    count, lr, scale, bc1, bc2 = step_scalars(hyper, count, gnorm)
    for p, g, mm, vv, dk in zip(params, grads, m, v, decay):
        update_leaf(p, g, mm, vv, dk, scale, lr, bc1, bc2, hyper)
    return count, lr, gnorm

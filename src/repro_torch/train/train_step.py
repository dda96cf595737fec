"""Train-step construction: loss, gradients, microbatch accumulation,
AdamW.

The port of ``repro/train/train_step.py``. ``make_train_step(cfg,
opt_cfg)`` returns ``(params, opt_state, batch) -> (params, opt_state,
metrics)``; batches are dicts of tensors on the parameters' device:

  LM:    {"tokens": (B, S) int, "labels": (B, S) int}
  audio: {"embeds": (B, S, d), "labels": (B, S) int}
  VLM:   {"tokens": (B, S_t) int, "embeds": (B, Np, d), "labels": (B, S)}

With ``n_microbatches > 1`` the leading batch dim is split and the
gradients are accumulated in fp32; ``remat`` checkpoints every layer
inside the model. The parameters and moments are updated in place
(:func:`repro_torch.train.optimizer.adamw_update`, over the trainable
leaves). A router's balancing bias (``models.moe.BIAS``) takes no
gradient and no part in AdamW, its decay or its clipping: after the
update it moves by ``moe.bias_update_speed * sign(mean load - load)``
from the step's expert loads (:func:`balance_biases`). A ``telemetry``
handed to ``make_train_step`` traces the step (``train.step`` >
``train.forward``, ``train.backward``, ``train.optimizer``,
``moe.balance``) and what runs inside it, whenever it is recording.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward, lm_loss
from repro_torch.models.moe import BIAS
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update, trainable)
from repro_torch.train.tree import Tree, leaves, tree_map

Batch = Dict[str, torch.Tensor]


def loss_fn(params: Tree, cfg: ModelConfig, batch: Batch,
            attention_impl: str = "auto", remat: bool = True,
            aux_weight: float = 0.01, impl: str = "kernel",
            telemetry: Telemetry = NULL_TELEMETRY
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss + aux_weight * aux, {"loss", "aux_loss"}) of one batch; the
    config's ``moe.aux_weight`` replaces ``aux_weight`` where it is set.
    With balancing biases the metrics also hold ``expert_load``, (MoE
    layers with a bias, E): the pairs that chose each expert."""
    loads: list = []
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          attention_impl=attention_impl, remat=remat,
                          impl=impl, telemetry=telemetry, loads=loads)
    loss = lm_loss(logits, batch["labels"])
    if cfg.moe is not None and cfg.moe.aux_weight is not None:
        aux_weight = cfg.moe.aux_weight
    total = loss + aux_weight * aux
    metrics = {"loss": loss.detach(), "aux_loss": aux.detach()}
    if loads:
        metrics["expert_load"] = torch.stack(loads)
    return total, metrics


def value_and_grad(params: Tree, lfn: Callable[..., Any], batch: Batch,
                   telemetry: Telemetry = NULL_TELEMETRY
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(metrics, gradients in leaf order) of ``lfn(params, batch=...)``:
    the leaves are differentiated through views that require grad, so
    the caller's tensors are not touched and nothing accumulates in
    ``.grad``. A leaf used twice (a tied table) gets the sum. The two
    passes are ``telemetry``'s ``train.forward`` and ``train.backward``
    spans."""
    flat = leaves(params)
    diff = [t.detach().requires_grad_(True) for t in flat]
    it = iter(diff)
    view = tree_map(lambda _: next(it), params)
    tracer = telemetry.tracer
    with torch.enable_grad():
        with tracer.span("train.forward"):
            total, metrics = lfn(view, batch=batch)
        with tracer.span("train.backward"):
            grads = torch.autograd.grad(total, diff, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    return metrics, grads


def compute_grads(params: Tree, lfn: Callable[..., Any], batch: Batch,
                  n_microbatches: int = 1,
                  telemetry: Telemetry = NULL_TELEMETRY
                  ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Metrics and gradients of one batch; with ``n_microbatches > 1`` the
    leading dim is split, the gradients summed in fp32 and divided by the
    count, the metrics averaged (the reference's ``lax.scan``)."""
    if n_microbatches == 1:
        return value_and_grad(params, lfn, batch, telemetry)
    parts = {k: torch.chunk(v, n_microbatches) for k, v in batch.items()}
    g_sum = m_sum = None
    for i in range(n_microbatches):
        metrics, grads = value_and_grad(
            params, lfn, {k: p[i] for k, p in parts.items()}, telemetry)
        if g_sum is None:
            g_sum = [g.to(torch.float32) for g in grads]
            m_sum = dict(metrics)
        else:
            for acc, g in zip(g_sum, grads):
                acc += g.to(torch.float32)
            m_sum = {k: m_sum[k] + metrics[k] for k in m_sum}
    return ({k: m / n_microbatches for k, m in m_sum.items()},
            [g / n_microbatches for g in g_sum])


def reference_decay_mask(params: Tree) -> Tree:
    """Which leaves AdamW decays, as the reference decides it on its own
    layout: a leaf of ``ndim >= 2`` there. The reference stacks every
    block leaf over the periods, so each of them has a leading period
    axis and is decayed, the blocks' norm scales and biases included;
    here those are per-layer leaves (``params["layers"]``) of one
    dimension less. Top-level leaves decay by their own ``ndim``."""
    mask = tree_map(lambda p: p.ndim >= 2, params)
    if "layers" in params:
        mask["layers"] = tree_map(lambda _: True, params["layers"])
    return mask


def bias_leaves(params: Tree) -> List[torch.Tensor]:
    """The balancing biases of the MoE layers that have one, in layer
    order."""
    return [layer["mlp"][BIAS] for layer in params.get("layers", [])
            if BIAS in layer.get("mlp", {})]


@torch.no_grad()
def balance_biases(params: Tree, load: torch.Tensor, cfg: ModelConfig
                   ) -> None:
    """DeepSeek-V3's auxiliary-loss-free balancing, in place: each MoE
    layer's bias b_e += gamma * sign(mean_e load - load_e), from ``load``
    (layers, E), gamma = ``cfg.moe.bias_update_speed``."""
    load = load.float()
    step = cfg.moe.bias_update_speed * torch.sign(
        load.mean(-1, keepdim=True) - load)
    for i, b in enumerate(bias_leaves(params)):
        b.add_(step[i])


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[OptimizerConfig] = None,
                    n_microbatches: int = 1,
                    attention_impl: str = "auto",
                    remat: bool = True, impl: str = "kernel",
                    telemetry: Telemetry = NULL_TELEMETRY) -> Callable:
    """A train step for ``cfg``: gradients of :func:`loss_fn`, then one
    AdamW update in place of the trainable leaves, decaying what the
    reference decays (:func:`reference_decay_mask`), then the balancing
    biases' move (:func:`balance_biases`, the ``moe.balance`` span) where
    the routers have them; ``impl`` picks the attention and AdamW kernels
    or their plain versions. Each call is ``telemetry``'s ``train.step``
    span."""
    opt_cfg = opt_cfg or OptimizerConfig()
    lfn = functools.partial(loss_fn, cfg=cfg, attention_impl=attention_impl,
                            remat=remat, impl=impl, telemetry=telemetry)

    def train_step(params: Tree, opt_state: Dict[str, Any], batch: Batch):
        with telemetry.tracer.span("train.step"):
            metrics, grads = compute_grads(params, lfn, batch,
                                           n_microbatches, telemetry)
            it = iter(grads)
            grads = tree_map(lambda _: next(it), params)
            train = trainable(params)
            _, opt_state, opt_metrics = adamw_update(
                train, trainable(grads), opt_state, opt_cfg,
                reference_decay_mask(train), telemetry, impl)
            load = metrics.pop("expert_load", None)
            if load is not None:
                with telemetry.tracer.span("moe.balance"):
                    balance_biases(params, load, cfg)
            metrics.update(opt_metrics)
            return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     opt_cfg: Optional[OptimizerConfig] = None,
                     device="cuda"):
    """Random parameters from ``seed`` on ``device`` and fresh AdamW
    state."""
    from repro_torch.models.model import init_params
    params = init_params(cfg, seed=seed, device=device)
    opt_state = adamw_init(params, opt_cfg or OptimizerConfig())
    return params, opt_state

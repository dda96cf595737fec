"""Abstract inputs of every (arch x shape) dry-run cell: parameters,
AdamW state, batches and decode inputs as ``DTensor``s whose local
shards are fake tensors, placed by the sharding rules.

The port of ``repro/launch/input_specs.py``: where the reference builds
``ShapeDtypeStruct``s with shardings, this builds ``DTensor``s over fake
tensors. Every function must run inside the caller's
``FakeTensorMode``: nothing is allocated, and each rank's local shard
has the shape it would have on the mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.model import init_decode_state, init_params
from repro_torch.sharding.partition import (P, RuleContext, ShardingPolicy,
                                            decode_state_specs, param_specs,
                                            place, place_tree)
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.train.tree import Tree

N_PATCHES = 256       # internvl2 vision stub


def abstract_params(cfg: ModelConfig, mesh: Any,
                    policy: ShardingPolicy) -> Tree:
    """The parameters of ``cfg``, placed on ``mesh`` by ``param_specs``."""
    params = init_params(cfg, device="cpu")
    return place_tree(params, param_specs(params, mesh, policy), mesh)


def abstract_opt_state(params: Tree, opt_cfg: OptimizerConfig
                       ) -> Dict[str, Any]:
    """AdamW state of placed ``params``: ``m`` and ``v`` placed as the
    parameters are, in ``opt_cfg.state_dtype``; ``count`` an int32
    scalar (the reference's ``P()``: every rank holds it)."""
    return adamw_init(params, opt_cfg)


def batch_shape(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per batch field for train/prefill inputs."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        d = {"embeds": ((B, S, cfg.d_model), torch.bfloat16)}
        if shape.kind == "train":
            d["labels"] = ((B, S), torch.int32)
        return d
    if cfg.frontend == "vision_patches":
        d = {"tokens": ((B, S - N_PATCHES), torch.int32),
             "embeds": ((B, N_PATCHES, cfg.d_model), torch.bfloat16)}
        if shape.kind == "train":
            d["labels"] = ((B, S), torch.int32)
        return d
    d = {"tokens": ((B, S), torch.int32)}
    if shape.kind == "train":
        d["labels"] = ((B, S), torch.int32)
    return d


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                   policy: ShardingPolicy) -> Dict[str, torch.Tensor]:
    """The batch of one step, its batch dim over the DP axes when
    divisible."""
    b_axes = RuleContext(mesh, policy).fit(policy.dp_axes,
                                           shape.global_batch)
    out = {}
    for name, (shp, dtype) in batch_shape(cfg, shape).items():
        spec = P(b_axes, *([None] * (len(shp) - 1)))
        out[name] = place(torch.zeros(shp, dtype=dtype), spec, mesh)
    return out


def abstract_decode_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                           policy: ShardingPolicy,
                           seq_axes: Optional[Tuple[str, ...]] = None
                           ) -> Dict[str, Any]:
    """Decode tokens (B, 1), state and positions (B,), placed as the
    reference places them. ``seq_axes`` shards the KV caches' sequence
    axis; by default ``model``, and for batch 1 (long_500k) every axis."""
    B, S = shape.global_batch, shape.seq_len
    if seq_axes is None:
        seq_axes = policy.dp_axes + ("model",) if B == 1 else ("model",)
    state = init_decode_state(cfg, B, S, device="cpu")
    specs = decode_state_specs(state, mesh, policy, B, seq_axes)
    b_axes = RuleContext(mesh, policy).fit(policy.dp_axes, B)
    return {"tokens": place(torch.zeros((B, 1), dtype=torch.int32),
                            P(b_axes, None), mesh),
            "state": place_tree(state, specs, mesh),
            "pos": place(torch.full((B,), S - 1, dtype=torch.int32),
                         P(b_axes), mesh)}

"""Assigned input shapes and per-(arch x shape) applicability rules.

  train_4k     seq 4,096   global_batch 256   lowers train_step
  prefill_32k  seq 32,768  global_batch 32    lowers prefill (forward)
  decode_32k   seq 32,768  global_batch 128   lowers serve_step (1 token, KV=seq)
  long_500k    seq 524,288 global_batch 1     lowers serve_step; sub-quadratic only

Skips follow the assignment rules (DESIGN.md §Shape skips): encoder-only
archs have no decode; long_500k runs only for SSM/hybrid archs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape: kind, sequence length, global batch."""
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Tuple[bool, Optional[str]]:
    """Returns (runnable, skip_reason)."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only arch: no autoregressive decode step"
    if shape.kind == "decode" and cfg.mla is not None:
        return False, ("latent attention: the port has no decode cache of "
                       "the latent yet")
    if shape.name == "long_500k":
        if cfg.family not in ("ssm", "hybrid"):
            return False, ("pure full-attention arch: long_500k requires "
                           "sub-quadratic sequence mixing")
    return True, None


def cells_for(cfg: ModelConfig):
    """All (shape, runnable, reason) cells for an architecture."""
    return [(s,) + shape_applicable(cfg, s) for s in SHAPES]

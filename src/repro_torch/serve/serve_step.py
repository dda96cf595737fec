"""Serve-step construction: batched single-token decode and prefill.

The port of ``repro/serve/serve_step.py``. ``serve_step``: (params,
tokens (B, 1), state, pos (B,)) -> (next_tokens (B, 1) int32, state'),
greedy argmax. ``prefill_step``: the full forward returning the
last-position logits (per-frame outputs for an encoder) — the compute
shape of serving prefill. Both run without autograd; ``impl="plain"``
runs the attention kernels' plain versions."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (decode_step, forward,
                                      refuse_latent_decode)
from repro_torch.sharding.local import batch_only, is_dtensor, on_local_shards


def _greedy(last: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 argmax."""
    return torch.argmax(last, dim=-1).to(torch.int32)[:, None]


def make_serve_step(cfg: ModelConfig, impl: str = "kernel") -> Callable:
    """A greedy batched decode step for ``cfg``. On ``DTensor`` logits
    each rank takes the argmax of its whole rows (the vocabulary
    gathered first). Latent attention raises here: it has no decode
    cache in the port yet."""
    refuse_latent_decode(cfg)

    @torch.no_grad()
    def serve_step(params, tokens: torch.Tensor, state, pos: torch.Tensor):
        logits, state = decode_step(params, cfg, tokens, state, pos,
                                    impl=impl)
        last = logits[:, -1]
        if is_dtensor(last):
            rows = batch_only(last)
            return on_local_shards(_greedy, last, (rows,), rows)(last), state
        return _greedy(last), state
    return serve_step


def make_prefill_step(cfg: ModelConfig, attention_impl: str = "auto",
                      impl: str = "kernel") -> Callable:
    """A prefill step for ``cfg``: next-token logits of a decoder, all
    frames' outputs of an encoder."""
    @torch.no_grad()
    def prefill_step(params, tokens=None, embeds=None):
        logits, _ = forward(params, cfg, tokens=tokens, embeds=embeds,
                            attention_impl=attention_impl, remat=True,
                            impl=impl)
        if cfg.encoder_only:
            return logits
        # A copy, so the (B, S, V) fp32 logits are freed on return.
        return logits[:, -1].contiguous()
    return prefill_step

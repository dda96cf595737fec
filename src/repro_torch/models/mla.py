"""Multi-head latent attention (DeepSeek-V2/V3's MLA, no query LoRA) over
a full sequence, for training and prefill.

For x (B, S, d) and heads h = 1..H:

  q = x W_q, each head [q_nope (nope_dim) | q_pe (rope_dim)];
  [c | k_pe] = x W_kv_a, c = RMSNorm(c) (a kv_rank-wide latent);
  [k_nope_h | v_h] = c W_kv_b, per head nope_dim + v_dim;
  q_pe and k_pe rotated by RoPE (the halves of the rope_dim slice); k_pe is
  one head, shared by every query head;
  o_h = causal softmax([q_nope_h | q_pe_h] [k_nope_h | k_pe]^T /
        sqrt(nope_dim + rope_dim)) v_h;  out = [o_1 ... o_H] W_o.

The attention core is the port's attention with a value head narrower
than the q/k head: the naive path at short sequences, the flash kernels at
the pair (nope_dim + rope_dim, v_dim) beyond (``models.attention``'s
"auto"). v is never padded to the q/k width. Parameters: ``wq`` (d, H *
qk), ``wkv_a`` (d, kv_rank + rope_dim), ``kv_norm`` (kv_rank,) fp32,
``wkv_b`` (kv_rank, H * (nope_dim + v_dim)) and ``wo`` (H * v_dim, d), in
(in, out) layout. A decode cache of the latent is not written yet, so the
serving paths refuse this mixer.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (_blockwise_attention, _expand_kv,
                                          _naive_attention, _on_heads)
from repro_torch.models.layers import (Params, apply_norm, matmul, normal,
                                       rope_tables, rotate)
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.sharding.local import split_heads


def init_mla(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The MLA mixer's parameters at 1/sqrt(fan-in); the latent's norm
    scale is ones, fp32."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    std = 1.0 / math.sqrt(d)
    return {
        "wq": normal(gen, (d, h * m.qk_dim), std, dtype),
        "wkv_a": normal(gen, (d, m.kv_rank + m.rope_dim), std, dtype),
        "kv_norm": torch.ones(m.kv_rank, dtype=torch.float32,
                              device=gen.device),
        "wkv_b": normal(gen, (m.kv_rank, h * (m.nope_dim + m.v_dim)),
                        1.0 / math.sqrt(m.kv_rank), dtype),
        "wo": normal(gen, (h * m.v_dim, d), 1.0 / math.sqrt(h * m.v_dim),
                     dtype),
    }


def rope_for(cfg: ModelConfig, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RoPE tables of the rope_dim slice at ``positions``."""
    return rope_tables(positions, cfg.mla.rope_dim, cfg.rope_theta)


def project(params: Params, x: torch.Tensor, cfg: ModelConfig,
            rope: Tuple[torch.Tensor, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q, k (B, S, H, qk) and v (B, S, H, v_dim)."""
    m = cfg.mla
    h = cfg.n_heads
    q = split_heads(matmul(x, params["wq"]), h, m.qk_dim)
    kva = matmul(x, params["wkv_a"])
    c = apply_norm({"scale": params["kv_norm"]}, kva[..., :m.kv_rank],
                   "rmsnorm")
    k_pe = rotate(kva[..., None, m.kv_rank:], rope)          # (B, S, 1, r)
    kvb = split_heads(matmul(c, params["wkv_b"]), h, m.nope_dim + m.v_dim)
    q = torch.cat([q[..., :m.nope_dim], rotate(q[..., m.nope_dim:], rope)],
                  dim=-1)
    k = torch.cat([kvb[..., :m.nope_dim],
                   k_pe.expand(*kvb.shape[:3], m.rope_dim)], dim=-1)
    return q, k, kvb[..., m.nope_dim:]


def core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         impl: str, kernel_impl: str) -> torch.Tensor:
    """Softmax attention of (B, S, H, qk) q, k and (B, S, H, v_dim) v,
    the heads merged: (B, S, H * v_dim). ``impl`` as in
    ``attention.attention_forward``."""
    if impl == "auto":
        impl = "naive" if q.shape[1] <= 2048 else "blockwise"
    if impl == "naive":
        def fn(q, k, v):
            return _naive_attention(q, _expand_kv(k, q.shape[2]),
                                    _expand_kv(v, q.shape[2]), causal)
    elif impl == "blockwise":
        def fn(q, k, v):
            return _blockwise_attention(q, k, v, causal, kernel_impl)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return _on_heads(fn, q, k, v)


def mla_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, causal: bool, impl: str = "auto",
                kernel_impl: str = "kernel",
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                telemetry: Telemetry = NULL_TELEMETRY) -> torch.Tensor:
    """Full-sequence MLA (training / prefill), in the spans
    ``mla.project``, ``mla.core`` (the attention core) and ``mla.out``.
    ``rope``: :func:`rope_for` of ``positions`` when the caller has
    them. x and the parameters are plain tensors: on a mesh the block
    runs this mixer on each rank's batch rows (``models.model``), so
    that its forty-odd small ops dispatch as plain tensor ops, not
    through ``DTensor`` on the host."""
    tracer = telemetry.tracer
    if rope is None:
        rope = rope_for(cfg, positions)
    with tracer.span("mla.project"):
        q, k, v = project(params, x, cfg, rope)
    with tracer.span("mla.core"):
        o = core(q, k, v, causal, impl, kernel_impl)
    with tracer.span("mla.out"):
        return matmul(o, params["wo"])

"""Shared layers: norms (incl. OLMo's non-parametric LN), RoPE, MLP
variants, embedding and the fp32-logit unembedding.

The port of ``repro/models/layers.py``. Parameters are plain dicts of
tensors; each init function takes a seeded ``torch.Generator`` and the
target device, each apply function (params, inputs). Weight matrices
keep the reference's ``(in, out)`` layout, so ``x @ w`` reads the same
on both sides. Compute follows the reference's dtype policy: bf16 by
default, fp32 for norms, RoPE and softmax. Where the reference lets JAX
promote mixed dtypes in a product (bf16 activations against fp32
weights), :func:`matmul` promotes the same way; PyTorch would refuse.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def default_dtype() -> torch.dtype:
    """The parameter and activation dtype of the reference: bfloat16."""
    return torch.bfloat16


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX computes it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def normal(gen: torch.Generator, shape: Sequence[int], std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """Standard normal draws on ``gen``'s device, times ``std``, cast to
    ``dtype`` (the reference's ``(normal(key, shape) * std).astype``)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


# ------------------------------------------------------------------ norms --

def init_norm(d: int, kind: str, device) -> Params:
    """Norm parameters in fp32: rmsnorm a scale, layernorm a scale and a
    bias, nonparam_ln none."""
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    if kind == "nonparam_ln":       # OLMo: LN without learnable params
        return {}
    raise ValueError(f"unknown norm {kind!r}")


def apply_norm(params: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalize the last axis in fp32; the result has x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"]
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            out = out * params["scale"] + params["bias"]
    return out.to(x.dtype)


# ------------------------------------------------------------------- RoPE --

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies ``theta ** (-2i / head_dim)``, fp32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of ``positions`` (broadcastable to (..., S)) times the
    inverse frequencies, fp32, shaped (..., S, 1, Dh/2) to broadcast over
    heads. A model computes them once and rotates every layer's q and k
    with them."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """x: (..., S, H, Dh) rotated by ``rope_tables``: the two halves of
    the head dim (no frequency scaling), in fp32, back in x's dtype."""
    cos, sin = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# -------------------------------------------------------------------- MLP --

def init_mlp(gen: torch.Generator, d: int, d_ff: int, mlp_type: str,
             dtype: torch.dtype) -> Params:
    """``w_in`` (d, d_ff) and ``w_out`` (d_ff, d), plus ``w_gate`` for
    swiglu, at the reference's init scales."""
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(d_ff)
    p: Params = {"w_in": normal(gen, (d, d_ff), std_in, dtype),
                 "w_out": normal(gen, (d_ff, d), std_out, dtype)}
    if mlp_type == "swiglu":
        p["w_gate"] = normal(gen, (d, d_ff), std_in, dtype)
    return p


def apply_mlp(params: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """swiglu, relu2 (Nemotron's squared ReLU) or gelu (tanh
    approximation, JAX's default)."""
    h = matmul(x, params["w_in"])
    if mlp_type == "swiglu":
        g = matmul(x, params["w_gate"])
        h = F.silu(g) * h
    elif mlp_type == "relu2":
        h = torch.square(F.relu(h))
    elif mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp {mlp_type!r}")
    return matmul(h, params["w_out"])


# -------------------------------------------------------------- embedding --

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype) -> Params:
    """A (vocab, d) table at scale 1/sqrt(d)."""
    return {"table": normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table for integer ``tokens``."""
    return params["table"][tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ table.T`` with fp32 accumulation, never making an
    fp32 copy of the (vocab, d) table on the card: there one
    ``torch.mm(..., out_dtype=float32)`` reads the table in its own
    dtype. The CPU has no such product, so there the activations and the
    table are cast to fp32 for the call (the plain path)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x2.dtype == table.dtype:
        out = torch.mm(x2, table.t(), out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), table.float().t())
    return out.reshape(*lead, table.shape[0])

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

from repro_torch.sharding.local import (batch_only, is_dtensor,
                                        on_local_shards, product,
                                        vocab_gather)

Params = Dict[str, torch.Tensor]


def default_dtype() -> torch.dtype:
    """The parameter and activation dtype of the reference: bfloat16."""
    return torch.bfloat16


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX computes it. A
    ``DTensor`` x sharded along an inner dim (the sequence, under
    sequence parallelism) is gathered along it first, as Megatron's
    sequence parallelism gathers before a projection
    (``sharding.local.product``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return product(x.to(dt), w.to(dt))


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
    """Rows of the table for integer ``tokens``, with ids mapped as the
    reference's gather maps them: a negative id counts from the end (id +
    V, as numpy indexes), then every id is clamped to [0, V - 1]. The
    mapping runs on the tokens' own device, before the gather. On a
    ``DTensor`` table each rank gathers from its vocab slice
    (``sharding.local.vocab_gather``)."""
    table = params["table"]
    vocab = table.shape[0]
    if is_dtensor(table):
        return vocab_gather(table, lambda t: _vocab_ids(t, vocab), tokens)
    return table[_vocab_ids(tokens, vocab)]


def _vocab_ids(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """Integer ids mapped as :func:`embed` says."""
    ids = tokens.long()
    return torch.where(ids < 0, ids + vocab, ids).clamp_(0, vocab - 1)


class _Unembed(torch.autograd.Function):
    """fp32 logits ``x @ table.T`` from a table and activations of one
    dtype on the card, with a gradient: PyTorch has none for the
    ``mm(..., out_dtype=float32)`` product. The backward is two cuBLAS
    products that read the table in its own dtype, as the reference's are
    XLA dots: ``dx = dlogits @ table`` in x's dtype (JAX's transpose of a
    dot with ``preferred_element_type=float32``), and ``dtable =
    dlogits.T @ x`` summed in fp32, then cast to the table's dtype. The
    fp32 ``dlogits`` is rounded to the table's dtype for both products,
    the operand rounding of the bf16 tensor cores (and of the reference's
    default-precision dots on its TPU)."""

    @staticmethod
    def forward(ctx, x2, table):
        """(N, d) x2, (V, d) table -> (N, V) fp32."""
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dlogits):
        """(dx2, dtable)."""
        x2, table = ctx.saved_tensors
        g = dlogits.to(table.dtype)
        dx = dtable = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, table, out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dtable = torch.mm(g.t(), x2, out_dtype=torch.float32).to(
                table.dtype)
        return dx, dtable


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ table.T`` with fp32 accumulation, never making an
    fp32 copy of the (vocab, d) table on the card: there one
    ``torch.mm(..., out_dtype=float32)`` reads the table in its own
    dtype, differentiable through :class:`_Unembed`. The CPU has no such
    product, so there the activations and the table are cast to fp32 for
    the call (the plain path, differentiated by autograd). On
    ``DTensor``s each rank computes its batch rows against its vocab
    slice of the table (``local_map``): the logits come out sharded as
    the rows and the vocabulary are."""
    if is_dtensor(x):
        return _unembed_on_mesh(table, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x2.dtype == table.dtype:
        out = _Unembed.apply(x2, table)
    else:
        out = torch.mm(x2.float(), table.float().t())
    return out.reshape(*lead, table.shape[0])


def _unembed_on_mesh(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`unembed` of ``DTensor``s: x whole in its features and the
    table whole in d, each rank's rows against its vocab slice."""
    from torch.distributed.tensor import Replicate, Shard
    vocab = [Shard(0) if p == Shard(0) else Replicate()
             for p in table.placements]
    # a mesh dim that splits the vocabulary gives each rank all rows
    rows = [Replicate() if v == Shard(0) else r
            for r, v in zip(batch_only(x), vocab)]
    out = [Shard(x.ndim - 1) if v == Shard(0) else r
           for r, v in zip(rows, vocab)]
    return on_local_shards(lambda t, h: unembed(t, h), x, (vocab, rows),
                           out)(table, x)

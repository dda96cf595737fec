"""Mixture-of-Experts MLP: top-k routing with capacity-based dispatch,
shared experts (DeepSeekMoE) and the Switch load-balance loss.

The port of ``repro/models/moe.py``. Experts live on the leading axis of
the weight stacks, and the expert products are batched GEMMs
(``torch.bmm``; the reference's einsums). ``cfg.moe_dispatch`` picks the
dispatch: ``"sort"`` (the default) scatters each kept (token, k) into
its own row of ``E * C + 1`` slots, the last one an overflow row that
every dropped (token, k) writes and that is thrown away, gradient and
all; ``"einsum"`` is the GShard one-hot formulation. Both give the same
routing, which :func:`route` computes once: :func:`route` picks each
token's experts, :func:`assign` derives the gates, the aux loss and the
queue positions from that choice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, matmul, normal
from repro_torch.sharding.local import (is_dtensor, on_local_shards,
                                        replicated, unreduced)


class Routing(NamedTuple):
    """One MoE layer's routing of T tokens to E experts, top K each.

    ``gates``: (T, K) fp32 renormalised gate values, zero where dropped;
    ``experts``: (T, K) expert ids in top-k order (descending
    probability, ties to the lower id); ``pos``: (T, K) each (token, k)'s
    place in its expert's queue; ``keep``: (T, K) ``pos < capacity``;
    ``capacity``: slots per expert; ``aux``: the fp32 load-balance
    loss."""
    gates: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The fp32 router (d, E), expert stacks ``w_in`` / ``w_gate`` (E, d,
    de) and ``w_out`` (E, de, d), and the shared experts ``sh_*`` (d,
    n_shared * de) when ``n_shared > 0``, at the reference's scales."""
    mc = cfg.moe
    assert mc is not None
    d, de, E, S = cfg.d_model, cfg.d_expert_resolved, mc.n_experts, \
        mc.n_shared
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(de)
    swiglu = cfg.mlp_type == "swiglu"
    p: Params = {"router": normal(gen, (d, E), std_in, torch.float32),
                 "w_in": normal(gen, (E, d, de), std_in, dtype),
                 "w_out": normal(gen, (E, de, d), std_out, dtype)}
    if swiglu:
        p["w_gate"] = normal(gen, (E, d, de), std_in, dtype)
    if S:
        p["sh_in"] = normal(gen, (d, S * de), std_in, dtype)
        p["sh_out"] = normal(gen, (S * de, d), std_out, dtype)
        if swiglu:
            p["sh_gate"] = normal(gen, (d, S * de), std_in, dtype)
    return p


def _activate(h: torch.Tensor, g: Optional[torch.Tensor],
              mlp_type: str) -> torch.Tensor:
    """swiglu ``silu(g) * h``, relu2, or gelu (tanh approximation)."""
    if mlp_type == "swiglu":
        return F.silu(g) * h
    if mlp_type == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig
          ) -> Routing:
    """Routing of xt (T, d): fp32 softmax over the router's logits, then
    the top k experts of each token by a stable descending sort
    (``jax.lax.top_k``'s order: ties go to the lower expert id, on every
    device), handed to :func:`assign`."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)   # (T, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    return assign(probs, order[:, :cfg.moe.top_k], cfg)


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``n`` ids occurs in ``ids`` (``bincount`` with
    ``minlength=n``, which on the card reads the largest id back to the
    host; this does not). Out of place: nothing writes into the fresh
    zeros."""
    return torch.zeros(n, dtype=ids.dtype, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids))


def assign(probs: torch.Tensor, experts: torch.Tensor, cfg: ModelConfig
           ) -> Routing:
    """The routing of T tokens with router probabilities ``probs`` (T, E)
    to ``experts`` (T, K): gates renormalised over the K, the aux loss
    over each token's first expert, and queue positions; a pair at
    position ``capacity`` or beyond is dropped.

    A pair's queue position is the number of pairs before it, in (t, k)
    order, routed to the same expert: the reference's exclusive cumsum
    over the (T * K, E) one-hot, computed here as each pair's rank in a
    stable sort by expert less its expert's first rank (the one-hot's
    cumsum runs down 64 columns of T * K rows, a scan the card does
    slowly)."""
    mc = cfg.moe
    T, K = experts.shape
    E = mc.n_experts
    gates = torch.gather(probs, -1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    ce = _counts(experts[:, 0], E).float() / T
    aux = E * torch.sum(probs.mean(0) * ce)

    capacity = max(1, int(mc.capacity_factor * K * T / E))
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True)[1]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    counts = _counts(flat, E)
    pos = (rank - (torch.cumsum(counts, 0) - counts)[flat]).reshape(T, K)
    keep = pos < capacity
    return Routing(gates * keep, experts, pos, keep, capacity, aux)


def _dispatch_sort(xt: torch.Tensor, r: Routing, E: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xe (E, C, d), slot (T, K)): each kept (token, k) copied into row
    ``expert * C + pos``; every dropped one into the overflow row ``E *
    C``, which is sliced off. The kept rows are distinct (a token's
    top-k experts are, and so are the queue positions within an expert),
    so only the discarded overflow row sees duplicate writes, whose
    order no device fixes."""
    C = r.capacity
    slot = torch.where(r.keep, r.experts * C + r.pos,
                       torch.full_like(r.pos, E * C))
    xe = torch.zeros((E * C + 1, xt.shape[1]), dtype=xt.dtype,
                     device=xt.device)
    for kk in range(slot.shape[1]):
        xe.index_put_((slot[:, kk],), xt)
    return xe[:E * C].reshape(E, C, -1), slot


def _combine_sort(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """y (T, d): the gated sum of each token's expert rows in fp32 (the
    overflow row reads as zeros), cast to ``dtype``."""
    E, C, d = ye.shape
    flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    y = torch.zeros((slot.shape[0], d), dtype=torch.float32,
                    device=ye.device)
    for kk in range(slot.shape[1]):
        y = y + flat[slot[:, kk]].float() * gates[:, kk, None].float()
    return y.to(dtype)


def _onehots(r: Routing, E: int, dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, K, E) expert and (T, K, C) slot one-hots in ``dtype``; a
    dropped (token, k) has a zero slot row (``jax.nn.one_hot`` of an
    index out of range). Built by comparison: an index is never clamped
    into the last slot."""
    dev = r.experts.device
    expert_oh = (r.experts[..., None] == torch.arange(E, device=dev))
    slot_idx = torch.where(r.keep, r.pos, torch.full_like(r.pos,
                                                          r.capacity))
    pos_oh = (slot_idx[..., None] == torch.arange(r.capacity, device=dev))
    return expert_oh.to(dtype), pos_oh.to(dtype)


def _dispatch(xt: torch.Tensor, r: Routing, E: int, einsum: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xe (E, C, d), what :func:`_combine` reads: the sort dispatch's
    slots, or the einsum dispatch's (T, E, C) combine weights)."""
    if not einsum:
        return _dispatch_sort(xt, r, E)
    expert_oh, pos_oh = _onehots(r, E, xt.dtype)
    disp = torch.einsum("tke,tkc->tec", expert_oh, pos_oh)
    comb = torch.einsum("tke,tkc,tk->tec", expert_oh.float(),
                        pos_oh.float(), r.gates.float()).to(xt.dtype)
    return torch.einsum("td,tec->ecd", xt, disp), comb


def _combine(ye: torch.Tensor, how: torch.Tensor, gates: torch.Tensor,
             einsum: bool, dtype: torch.dtype) -> torch.Tensor:
    """y (T, d) from the expert outputs ``ye`` (E, C, d)."""
    if einsum:
        return torch.einsum("ecd,tec->td", ye, how)
    return _combine_sort(ye, how, gates, dtype)


def _experts(params: Params, xe: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """ye (E, C, d): every expert's MLP over its slots, batched GEMMs."""
    h = matmul(xe, params["w_in"])                               # (E, C, de)
    g = matmul(xe, params["w_gate"]) if "w_gate" in params else None
    return matmul(_activate(h, g, cfg.mlp_type), params["w_out"])


def _shared(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """The shared experts' MLP over x (..., d)."""
    hs = matmul(x, params["sh_in"])
    gs = matmul(x, params["sh_gate"]) if "sh_gate" in params else None
    return matmul(_activate(hs, gs, cfg.mlp_type), params["sh_out"])


def _routed_on_mesh(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    einsum: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed half of :func:`moe_forward` on a (B, S, d) ``DTensor``.

    Routing couples every token of the batch (the capacity and the queue
    positions count them all), so every rank routes all of them: the
    tokens and the router are gathered, and routing, dispatch and combine
    run on each rank's whole copy (``local_map``). The expert products
    run as DTensor batched GEMMs with the expert axis where the expert
    stacks have it (over ``model``), and their outputs are gathered for
    the combine. The result is what the unplaced layer computes; each
    rank then keeps its own rows."""
    from torch.distributed.tensor import Replicate, Shard
    E = cfg.moe.n_experts
    B, S, d = x.shape
    rep = replicated(x)

    def route_dispatch(x, router):
        xt = x.reshape(B * S, d)
        r = route(router, xt, cfg)
        xe, how = _dispatch(xt, r, E, einsum)
        return xe, how, r.gates, r.aux

    def combine(ye, how, gates):
        return _combine(ye, how, gates, einsum, x.dtype).reshape(B, S, d)

    xe, how, gates, aux = on_local_shards(
        route_dispatch, x, (rep, rep), (rep, rep, rep, rep))(
            x, params["router"])
    experts = [p if p == Shard(0) else Replicate()
               for p in params["w_in"].placements]
    ye = _experts(params, xe.redistribute(xe.device_mesh, experts), cfg)
    y = on_local_shards(combine, x, (rep, rep, rep), rep)(
        ye.redistribute(ye.device_mesh, rep), how, gates)
    return y.redistribute(x.device_mesh, unreduced(x)), aux


def moe_forward(params: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), fp32 aux loss). On ``DTensor``s the
    routed experts run as :func:`_routed_on_mesh` says."""
    einsum = getattr(cfg, "moe_dispatch", "sort") == "einsum"
    if is_dtensor(x):
        y, aux = _routed_on_mesh(params, x, cfg, einsum)
        if "sh_in" in params:
            y = y + _shared(params, x, cfg)
        return y, aux
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(params["router"], xt, cfg)
    xe, how = _dispatch(xt, r, cfg.moe.n_experts, einsum)
    y = _combine(_experts(params, xe, cfg), how, r.gates, einsum, x.dtype)
    y = y.reshape(B, S, d)
    if "sh_in" in params:
        # on x (B, S, d), as the mesh path takes it: x's gradient sums
        # the routed and the shared part in one order on both paths
        y = y + _shared(params, x, cfg)
    return y, r.aux

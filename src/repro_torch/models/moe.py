"""Mixture-of-Experts MLP: top-k routing with capacity-based dispatch,
shared experts (DeepSeekMoE) and the Switch load-balance loss; or
DeepSeek-V3's router (``moe.scoring == "sigmoid"``): sigmoid scores, each
token's top k chosen by score plus the layer's balancing bias (its leaf
``score_bias``, fp32, (E,), which no gradient reaches: the train step
moves it from each step's expert load), gates from the unbiased scores
renormalised over the k and times ``moe.routed_scale``, and the
sequence-wise balance loss.

A layer may hold only part of the experts (``moe.n_held``, an expert
parallel group's share on this chip): it routes over all ``n_experts``
and computes the part of the result its held experts give. Its weight
stacks have the held experts' rows; a pair chosen for an absent expert is
never dispatched (it takes no slot, no row and no write), and the
dispatch, the combine and their gradients are gathers by the slots' pairs
and the pairs' slots, with no accumulating scatter
(:class:`_DispatchHeld`, :class:`_CombineHeld`).

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
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.sharding.local import (is_dtensor, on_local_shards,
                                        replicated, unreduced)


#: The leaf name of a router's balancing bias: state the train step
#: moves, not a parameter the optimizer updates.
BIAS = "score_bias"


class Routing(NamedTuple):
    """One MoE layer's routing of T tokens to E experts, top K each.

    ``gates``: (T, K) fp32 renormalised gate values, zero where dropped;
    ``experts``: (T, K) expert ids in top-k order (descending
    probability, ties to the lower id); ``pos``: (T, K) each (token, k)'s
    place in its expert's queue; ``keep``: (T, K) ``pos < capacity``;
    ``capacity``: slots per expert; ``aux``: the fp32 load-balance
    loss; ``load``: (E,) how many of the T * K pairs chose each expert,
    where the router has a balancing bias (else None); ``held``: (T, K)
    whether the pair's expert is held here, and ``src``: (H * C,) the
    flat index t * K + k of the pair in each slot of the H held experts,
    T * K where the slot stays empty, for a layer that holds part of the
    experts (else None)."""
    gates: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: torch.Tensor
    load: Optional[torch.Tensor] = None
    held: Optional[torch.Tensor] = None
    src: Optional[torch.Tensor] = None


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The fp32 router (d, E), expert stacks ``w_in`` / ``w_gate`` (E, d,
    de) and ``w_out`` (E, de, d) (of the held experts only, where the layer
    holds part of them), and the shared experts ``sh_*`` (d, n_shared *
    de) when ``n_shared > 0``, at the reference's scales; with sigmoid
    scoring also the balancing bias (E,), fp32 zeros."""
    mc = cfg.moe
    assert mc is not None
    d, de, E, S = cfg.d_model, cfg.d_expert_resolved, mc.n_experts, \
        mc.n_shared
    H = mc.held
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(de)
    swiglu = cfg.mlp_type == "swiglu"
    p: Params = {"router": normal(gen, (d, E), std_in, torch.float32),
                 "w_in": normal(gen, (H, d, de), std_in, dtype),
                 "w_out": normal(gen, (H, de, d), std_out, dtype)}
    if swiglu:
        p["w_gate"] = normal(gen, (H, d, de), std_in, dtype)
    if S:
        p["sh_in"] = normal(gen, (d, S * de), std_in, dtype)
        p["sh_out"] = normal(gen, (S * de, d), std_out, dtype)
        if swiglu:
            p["sh_gate"] = normal(gen, (d, S * de), std_in, dtype)
    if mc.scoring == "sigmoid":
        p[BIAS] = torch.zeros(E, dtype=torch.float32, device=gen.device)
    return p


def _activate(h: torch.Tensor, g: Optional[torch.Tensor],
              mlp_type: str) -> torch.Tensor:
    """swiglu ``silu(g) * h``, relu2, or gelu (tanh approximation)."""
    if mlp_type == "swiglu":
        return F.silu(g) * h
    if mlp_type == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
          bias: Optional[torch.Tensor] = None, seq: Optional[int] = None
          ) -> Routing:
    """Routing of xt (T, d): fp32 softmax over the router's logits, then
    the top k experts of each token by a stable descending sort
    (``jax.lax.top_k``'s order: ties go to the lower expert id, on every
    device), handed to :func:`assign`. Under sigmoid scoring,
    :func:`route_sigmoid` with the balancing ``bias`` and the rows'
    length ``seq``."""
    if cfg.moe.scoring == "sigmoid":
        return route_sigmoid(router, xt, cfg, bias, seq)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)   # (T, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    return assign(probs, order[:, :cfg.moe.top_k], cfg)


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(T, k) ids of each row's k largest, stable (ties to the lower
    id)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def route_sigmoid(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
                  bias: torch.Tensor, seq: int) -> Routing:
    """DeepSeek-V3's routing of xt (T, d), T = rows x ``seq``: fp32 scores
    s = sigmoid(x W_r) over all E experts; each token's top k by s +
    ``bias`` (one group: ``n_group = topk_group = 1``); gates s[top k]
    over their sum, times ``moe.routed_scale``; the aux loss is the
    sequence-wise balance loss (DeepSeek-V3 eq. 17-20 without its alpha):
    over each row, sum_e f_e P_e with f_e = E / (k seq) times the pairs of
    the row whose unbiased top k holds e, and P_e the row's mean of s_e /
    sum_j s_j; then the mean over rows. Queue positions and capacity as
    :func:`assign` counts them, over all E experts; ``load`` counts the
    chosen pairs of each expert, ``held`` marks those of held experts and
    ``src`` lists the pair in each held slot: slot p of expert e holds the
    p-th pair (in (t, k) order) that chose e, read off the queue's sort
    by gathers alone."""
    mc = cfg.moe
    T = xt.shape[0]
    E, K = mc.n_experts, mc.top_k
    scores = torch.sigmoid(xt.float() @ router.float())          # (T, E)
    experts = _top(scores + bias.float(), K)
    gates = torch.gather(scores, -1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9) * \
        mc.routed_scale

    rows = T // seq
    norm = scores / scores.sum(-1, keepdim=True)
    share = norm.reshape(rows, seq, E).mean(1)                   # P (rows, E)
    chosen = _top(scores, K).reshape(rows, seq * K)
    f = torch.zeros((rows, E), dtype=torch.float32, device=xt.device
                    ).scatter_add(1, chosen, torch.ones_like(
                        chosen, dtype=torch.float32)) * (E / (K * seq))
    aux = (f * share).sum(-1).mean()

    capacity, pos, keep, order, counts = _queue(experts, mc.capacity_factor,
                                                E)
    held = src = None
    if mc.partial:
        off, H = mc.held_offset, mc.held
        held = (experts >= off) & (experts < off + H)
        mine = torch.arange(off, off + H, device=xt.device)
        p = torch.arange(capacity, device=xt.device)
        first = (torch.cumsum(counts, 0) - counts)[mine]
        filled = p < counts[mine, None]                           # (H, C)
        src = torch.where(filled, order[(first[:, None] + p).clamp(
            max=T * K - 1)], T * K).reshape(-1)
    return Routing(gates * keep, experts, pos, keep, capacity, aux, counts,
                   held, src)


def _queue(experts: torch.Tensor, capacity_factor: float, E: int
           ) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """(capacity, pos, keep, order, counts) of the (T, K) choice
    ``experts`` over E experts, as :func:`assign` says: ``order`` the flat
    pairs sorted by expert (stable), ``counts`` each expert's pairs."""
    T, K = experts.shape
    capacity = max(1, int(capacity_factor * K * T / E))
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True)[1]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    counts = _counts(flat, E)
    pos = (rank - (torch.cumsum(counts, 0) - counts)[flat]).reshape(T, K)
    return capacity, pos, pos < capacity, order, counts


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

    capacity, pos, keep, _, _ = _queue(experts, mc.capacity_factor, E)
    return Routing(gates * keep, experts, pos, keep, capacity, aux)


def _count(telemetry: Telemetry, r: Routing, E: int) -> None:
    """The layer's routed (token, k) pairs, kept pairs and expert slots
    into ``telemetry``'s counters ``moe.pairs``, ``moe.kept_pairs`` and
    ``moe.slots`` (the kept ones stay on the device until it stops). A
    layer that holds part of the experts also counts ``moe.held_pairs``,
    the pairs chosen for a held expert, and counts the kept pairs and the
    slots of its ``E`` held experts only."""
    if telemetry.counting:
        telemetry.count("moe.pairs", r.keep.numel())
        if r.held is None:
            telemetry.count("moe.kept_pairs", r.keep.sum())
        else:
            telemetry.count("moe.held_pairs", r.held.sum())
            telemetry.count("moe.kept_pairs", (r.keep & r.held).sum())
        telemetry.count("moe.slots", E * r.capacity)


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


def _dispatch_held(xt: torch.Tensor, r: Routing, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of a layer that holds part of the experts: (xe (H, C,
    d) over the H held experts, what :class:`_CombineHeld` reads). Slot p
    of held expert e is filled from the pair ``r.src`` names, by a gather
    (:class:`_DispatchHeld`); an empty slot reads zeros. A pair that is
    dropped or chose an absent expert is never dispatched: it has no slot
    and no row, and no write of the forward or the backward goes to a
    row of its own. ``how`` is the (T, K) slots (``H * C`` for such a
    pair) and ``r.src``, flat in one tensor."""
    mc = cfg.moe
    H, C = mc.held, r.capacity
    slot = torch.where(r.keep & r.held, (r.experts - mc.held_offset) * C +
                       r.pos, torch.full_like(r.pos, H * C))
    xe = _DispatchHeld.apply(xt, slot, r.src)
    return xe.reshape(H, C, -1), torch.cat([slot.reshape(-1), r.src])


class _DispatchHeld(torch.autograd.Function):
    """xe (H * C, d): row s is xt's token of the pair ``src[s]`` (zeros
    for an empty slot), gathered; the gradient is gathered back, each
    token summing its K slots' rows in fp32 (``slot`` (T, K), ``H * C``
    where a pair has none): no accumulating scatter."""

    @staticmethod
    def forward(ctx, xt, slot, src):
        """xt (T, d) -> xe (H * C, d)."""
        T, K = slot.shape
        ctx.save_for_backward(slot)
        xe = xt.index_select(0, torch.div(src, K, rounding_mode="floor")
                             .clamp(max=T - 1))
        return xe.masked_fill((src >= T * K)[:, None], 0)

    @staticmethod
    def backward(ctx, dxe):
        """(dxt, None, None)."""
        (slot,) = ctx.saved_tensors
        n = dxe.shape[0]
        dxt = torch.zeros((slot.shape[0], dxe.shape[1]), dtype=torch.float32,
                          device=dxe.device)
        for kk in range(slot.shape[1]):
            rows = dxe.index_select(0, slot[:, kk].clamp(max=n - 1))
            dxt += rows.float().masked_fill((slot[:, kk] >= n)[:, None], 0)
        return dxt.to(dxe.dtype), None, None


class _CombineHeld(torch.autograd.Function):
    """y (T, d) of a layer that holds part of the experts: each token's
    gated sum of its held, kept pairs' expert rows in fp32, cast to
    ``dtype`` (:func:`_combine_sort`'s arithmetic). The gradient is
    gathered too: slot s's row takes ``dy * gate`` of the pair
    ``src[s]``, a pair's gate the dot of its row with ``dy``, and no
    pair without a slot is read or written."""

    @staticmethod
    def forward(ctx, ye, how, gates, dtype):
        """ye (H, C, d), ``how`` from :func:`_dispatch_held` -> y."""
        T, K = gates.shape
        slot, src = how[:T * K].view(T, K), how[T * K:]
        H, C, d = ye.shape
        flat = ye.reshape(H * C, d)
        live = slot < H * C
        ctx.save_for_backward(ye, slot, src, gates)
        y = torch.zeros((T, d), dtype=torch.float32, device=ye.device)
        for kk in range(K):
            row = flat.index_select(0, slot[:, kk].clamp(max=H * C - 1))
            y = y + row.float() * (gates[:, kk] * live[:, kk])[:, None].float()
        return y.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        """(dye, None, dgates, None)."""
        ye, slot, src, gates = ctx.saved_tensors
        H, C, d = ye.shape
        T, K = slot.shape
        flat = ye.reshape(H * C, d)
        dyf = dy.float()
        empty = src >= T * K
        gate = gates.reshape(-1)[src.clamp(max=T * K - 1)].float() \
            .masked_fill(empty, 0)
        tok = torch.div(src, K, rounding_mode="floor").clamp(max=T - 1)
        dye = (dyf.index_select(0, tok) * gate[:, None]).to(ye.dtype)
        dgates = torch.empty((T, K), dtype=torch.float32, device=ye.device)
        for kk in range(K):
            row = flat.index_select(0, slot[:, kk].clamp(max=H * C - 1))
            dgates[:, kk] = ((row.float() * dyf).sum(-1)
                             .masked_fill(slot[:, kk] >= H * C, 0))
        return dye.reshape(H, C, d), None, dgates.to(gates.dtype), None


def _dispatch(xt: torch.Tensor, r: Routing, E: int, einsum: bool,
              cfg: Optional[ModelConfig] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xe (E, C, d), what :func:`_combine` reads: the sort dispatch's
    slots, or the einsum dispatch's (T, E, C) combine weights). A routing
    with ``held`` takes :func:`_dispatch_held` (the einsum dispatch has
    no such form and raises)."""
    if r.held is not None:
        if einsum:
            raise NotImplementedError("the einsum dispatch takes no layer "
                                      "that holds part of the experts")
        return _dispatch_held(xt, r, cfg)
    if not einsum:
        return _dispatch_sort(xt, r, E)
    expert_oh, pos_oh = _onehots(r, E, xt.dtype)
    disp = torch.einsum("tke,tkc->tec", expert_oh, pos_oh)
    comb = torch.einsum("tke,tkc,tk->tec", expert_oh.float(),
                        pos_oh.float(), r.gates.float()).to(xt.dtype)
    return torch.einsum("td,tec->ecd", xt, disp), comb


def _combine(ye: torch.Tensor, how: torch.Tensor, gates: torch.Tensor,
             einsum: bool, dtype: torch.dtype, held: bool = False
             ) -> torch.Tensor:
    """y (T, d) from the expert outputs ``ye`` (E, C, d); ``held``: a
    layer that holds part of the experts (:class:`_CombineHeld`)."""
    if einsum:
        return torch.einsum("ecd,tec->td", ye, how)
    if held:
        return _CombineHeld.apply(ye, how, gates, dtype)
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
                    einsum: bool, telemetry: Telemetry
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """The routed half of :func:`moe_forward` on a (B, S, d) ``DTensor``:
    (y, aux, the expert load or None).

    Routing couples every token of the batch (the capacity and the queue
    positions count them all), so every rank routes all of them: the
    tokens and the router (and its balancing bias) are gathered, and
    routing, dispatch and combine run on each rank's whole copy
    (``local_map``). The expert products run as DTensor batched GEMMs
    with the expert axis where the expert stacks have it (over
    ``model``), and their outputs are gathered for the combine. The result
    is what the unplaced layer computes; each rank then keeps its own
    rows."""
    from torch.distributed.tensor import Replicate, Shard
    E = cfg.moe.n_experts
    B, S, d = x.shape
    rep = replicated(x)
    tracer = telemetry.tracer
    bias = params.get(BIAS)
    held = cfg.moe.partial

    def route_dispatch(x, router, *bias):
        xt = x.reshape(B * S, d)
        with tracer.span("moe.route"):
            r = route(router, xt, cfg, *bias, *((S,) if bias else ()))
        _count(telemetry, r, cfg.moe.held)
        with tracer.span("moe.dispatch"):
            xe, how = _dispatch(xt, r, E, einsum, cfg)
        return (xe, how, r.gates, r.aux) + ((r.load,) if bias else ())

    def combine(ye, how, gates):
        return _combine(ye, how, gates, einsum, x.dtype,
                        held).reshape(B, S, d)

    extra = (bias,) if bias is not None else ()
    out = on_local_shards(
        route_dispatch, x, (rep, rep) + (rep,) * len(extra),
        (rep,) * (4 + len(extra)))(x, params["router"], *extra)
    xe, how, gates, aux = out[:4]
    experts = [p if p == Shard(0) else Replicate()
               for p in params["w_in"].placements]
    with tracer.span("moe.experts"):
        ye = _experts(params, xe.redistribute(xe.device_mesh, experts), cfg)
    with tracer.span("moe.combine"):
        y = on_local_shards(combine, x, (rep, rep, rep), rep)(
            ye.redistribute(ye.device_mesh, rep), how, gates)
        return y.redistribute(x.device_mesh, unreduced(x)), aux, \
            (out[4] if extra else None)


def moe_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                telemetry: Telemetry = NULL_TELEMETRY,
                loads: Optional[list] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), fp32 aux loss). On ``DTensor``s the
    routed experts run as :func:`_routed_on_mesh` says. ``telemetry``
    traces each stage (``moe.route``, ``moe.dispatch``, ``moe.experts``,
    ``moe.combine``, ``moe.shared``) and counts the routing
    (:func:`_count`). A router with a balancing bias appends the layer's
    expert load (E,) to ``loads`` when one is given."""
    einsum = getattr(cfg, "moe_dispatch", "sort") == "einsum"
    tracer = telemetry.tracer
    load = None
    if is_dtensor(x):
        y, aux, load = _routed_on_mesh(params, x, cfg, einsum, telemetry)
    else:
        B, S, d = x.shape
        E = cfg.moe.n_experts
        xt = x.reshape(B * S, d)
        with tracer.span("moe.route"):
            r = route(params["router"], xt, cfg,
                      *((params[BIAS], S) if BIAS in params else ()))
        _count(telemetry, r, cfg.moe.held)
        with tracer.span("moe.dispatch"):
            xe, how = _dispatch(xt, r, E, einsum, cfg)
        with tracer.span("moe.experts"):
            ye = _experts(params, xe, cfg)
        with tracer.span("moe.combine"):
            y = _combine(ye, how, r.gates, einsum, x.dtype,
                         r.held is not None).reshape(B, S, d)
        aux, load = r.aux, r.load
    if loads is not None and load is not None:
        loads.append(load)
    if "sh_in" in params:
        # on x (B, S, d) on both paths: x's gradient sums the routed and
        # the shared part in one order on both
        with tracer.span("moe.shared"):
            y = y + _shared(params, x, cfg)
    return y, aux

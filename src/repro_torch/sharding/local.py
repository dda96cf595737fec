"""Model code on a device mesh: what the layers do when their tensors are
``DTensor``s.

The port's layers are written for plain tensors. Placed on a mesh
(``launch.train``, ``launch.dryrun``), parameters and batches are
``DTensor``s and most ops carry their placements through DTensor's own
sharding rules. What has no such rule runs on each rank's local shards
under ``local_map``: the hand-written attention kernels (heads over the
tensor-parallel axis, batch rows over the data axes), MoE routing, and
the SSM recurrences. With no mesh every helper here is the identity or
a plain call, so the unplaced model runs exactly as before.

``torch.distributed.tensor`` is imported on the mesh path only: once
imported, it slows the eager dispatch of plain tensors on the card (an
MoE decode step, host-bound, took about a third longer with the import
alone on an H100 under torch 2.11, PERF.md §6).
"""
from __future__ import annotations

import functools
import sys
from typing import Any, List, Optional, Sequence

import torch

#: The tensor-parallel mesh axis (``ShardingPolicy.tp_axis``).
TP_AXIS = "model"


def _api():
    """``torch.distributed.tensor``, imported when first needed."""
    import torch.distributed.tensor as dt
    return dt


def is_dtensor(x: Any) -> bool:
    """True for a ``DTensor`` (none exists before
    ``torch.distributed.tensor`` is imported)."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def _axis_index(mesh: Any, name: str) -> Optional[int]:
    """The mesh dim named ``name``, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def seq_parallel(h: torch.Tensor, tp_axis: str = TP_AXIS) -> torch.Tensor:
    """The reference's per-block ``with_sharding_constraint(h, P(None,
    "model", None))``: a (B, S, d) ``DTensor`` is redistributed to
    ``Shard(1)`` (sequence) on the ``tp_axis`` mesh dim, its other dims
    kept. A plain tensor, or a mesh with no such axis or an axis of size
    1, passes through unchanged."""
    if not is_dtensor(h):
        return h
    mesh = h.device_mesh
    i = _axis_index(mesh, tp_axis)
    if i is None or mesh.size(i) == 1:
        return h
    placements = list(h.placements)
    placements[i] = _api().Shard(1)
    return h.redistribute(mesh, placements)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` sharded along a dim other than its first and last
    (batch and features), redistributed to replicate that dim; anything
    else unchanged. Flattening such a tensor's leading dims for a
    product gives a strided sharding that DTensor's product rules do not
    take (torch 2.13)."""
    if not is_dtensor(x) or x.ndim <= 2:
        return x
    dt = _api()
    inner = [isinstance(p, dt.Shard) and 0 < p.dim < x.ndim - 1
             for p in x.placements]
    if not any(inner):
        return x
    return x.redistribute(x.device_mesh,
                          [dt.Replicate() if i else p
                           for i, p in zip(inner, x.placements)])


def _rows2d(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` (..., n) as (rows, n): inner dims gathered first
    (:func:`gather_inner`), so the flattened row dim keeps a plain batch
    sharding."""
    t = gather_inner(t)
    return t.reshape(-1, t.shape[-1])


class _Product(torch.autograd.Function):
    """``x @ w`` of a ``DTensor`` x (..., k) and w (k, n) as one 2-D
    product, and its gradient the same way: the upstream gradient is
    gathered along inner dims before it is flattened, as the forward's
    input is. The products are the ones autograd would run for
    ``torch.matmul`` (``dx = g w^T``, ``dw = x^T g``)."""

    @staticmethod
    def forward(ctx, x, w):
        """(..., n) ``x @ w``."""
        lead = x.shape[:-1]
        x2 = _rows2d(x)
        ctx.save_for_backward(x2, w)
        ctx.lead = lead
        return torch.mm(x2, w).reshape(*lead, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        """(dx, dw)."""
        x2, w = ctx.saved_tensors
        g2 = _rows2d(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g2, w.t()).reshape(*ctx.lead, w.shape[0])
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.t(), g2)
        return dx, dw


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of same-dtype operands: ``torch.matmul`` on plain
    tensors; :class:`_Product` for a ``DTensor`` x of more than two dims
    against a 2-D w (flattening a tensor sharded along both its batch and
    an inner dim gives a strided sharding that DTensor's product rules
    do not take, torch 2.13)."""
    if is_dtensor(x) and x.ndim > 2 and w.ndim == 2:
        return _Product.apply(x, w)
    return torch.matmul(gather_inner(x), w)


def split_heads(t: torch.Tensor, heads: int, head_dim: int,
                tp_axis: str = TP_AXIS) -> torch.Tensor:
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim). A ``DTensor``
    whose last dim is sharded over ``tp_axis`` by a size that does not
    divide ``heads`` is gathered along it first (a head is never split
    between ranks)."""
    if is_dtensor(t):
        dt = _api()
        mesh = t.device_mesh
        i = _axis_index(mesh, tp_axis)
        last = t.ndim - 1
        if i is not None and t.placements[i] == dt.Shard(last) \
                and heads % mesh.size(i):
            placements = list(t.placements)
            placements[i] = dt.Replicate()
            t = t.redistribute(mesh, placements)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def head_placements(ref: torch.Tensor, head_dim: int,
                    heads: Sequence[int],
                    tp_axis: str = TP_AXIS) -> List[Any]:
    """Placements that give each rank whole heads and whole batch rows of
    a ``DTensor`` like ``ref``: ``Shard(head_dim)`` on ``tp_axis`` when
    every count in ``heads`` (query and KV heads, which must split alike
    for GQA) divides by its size, else ``Replicate()``; on every other
    mesh dim ``Shard(0)`` where ``ref`` is batch-sharded, else
    ``Replicate()``."""
    dt = _api()
    mesh = ref.device_mesh
    out = []
    for i, p in enumerate(ref.placements):
        if (mesh.mesh_dim_names or ())[i] == tp_axis:
            n = mesh.size(i)
            out.append(dt.Shard(head_dim) if all(h % n == 0 for h in heads)
                       else dt.Replicate())
        else:
            out.append(dt.Shard(0) if p == dt.Shard(0) else dt.Replicate())
    return out


def replicated(ref: torch.Tensor) -> List[Any]:
    """``Replicate()`` on every dim of ``ref``'s mesh."""
    return [_api().Replicate()] * ref.device_mesh.ndim


def unreduced(ref: torch.Tensor) -> List[Any]:
    """``ref``'s placements with every pending sum (``Partial``) replaced
    by ``Replicate()``: a layout a result can be redistributed to."""
    return [_api().Replicate() if p.is_partial() else p
            for p in ref.placements]


def batch_only(ref: torch.Tensor) -> List[Any]:
    """``ref``'s batch sharding kept, every other dim replicated: each rank
    holds whole rows of its batch shard."""
    dt = _api()
    return [dt.Shard(0) if p == dt.Shard(0) else dt.Replicate()
            for p in ref.placements]


def as_dtensor(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` as a ``DTensor`` on ``ref``'s mesh: itself if it is one, else
    the same tensor on every rank (replicated)."""
    if is_dtensor(t):
        return t
    return _api().DTensor.from_local(t, ref.device_mesh, replicated(ref),
                                     run_check=False)


def moved_dims(t: torch.Tensor, ref: torch.Tensor) -> List[int]:
    """The mesh dims of more than one rank on which ``DTensor`` ``t``'s
    placement differs from ``ref``'s. On a dim of one rank every placement
    holds the same local tensor (a pending sum over one rank is the sum),
    so only these dims move data when ``t`` is placed like ``ref``."""
    mesh = ref.device_mesh
    return [d for d, (a, b) in enumerate(zip(t.placements, ref.placements))
            if a != b and mesh.size(d) > 1]


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard (its storage: an in-place write to it
    writes the ``DTensor``); anything else as it is."""
    return t.to_local() if is_dtensor(t) else t


def sum_over_shards(sums: torch.Tensor, refs: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """``sums[i]``, a sum over the local shard of ``refs[i]``, turned into
    sums over whole leaves: the leaves that mesh dims of more than one
    rank shard are summed in groups (those sharded over the same dims,
    first seen first) and each group all-reduced over its dims, as
    DTensor's ``torch.sum`` reduces a sharded leaf. Returns a vector
    whose total is the whole tree's sum: ``sums`` itself where nothing
    is sharded over more than one rank (plain tensors, a one-rank mesh),
    else one entry a group."""
    groups: dict = {}
    for i, t in enumerate(refs):
        dims: tuple = ()
        if is_dtensor(t):
            dims = tuple(d for d, p in enumerate(t.placements)
                         if p.is_shard() and t.device_mesh.size(d) > 1)
        groups.setdefault(dims, []).append(i)
    if not any(groups):
        return sums
    dt = _api()
    out = []
    for dims, idx in groups.items():
        s = torch.stack([sums[i] for i in idx]).sum()
        if dims:
            mesh = refs[idx[0]].device_mesh
            s = dt.DTensor.from_local(
                s, mesh, [dt.Partial() if d in dims else dt.Replicate()
                          for d in range(mesh.ndim)],
                run_check=False).full_tensor()
        out.append(s)
    return torch.stack(out)


def on_local_shards(fn, ref: torch.Tensor, in_placements, out_placements):
    """``fn`` run on each rank's local shards of its ``DTensor``
    arguments, redistributed to ``in_placements`` first; its outputs
    become ``DTensor``s with ``out_placements`` on ``ref``'s mesh.

    Where an argument is sharded along a mesh dim, the ranks of that dim
    split the work, so an argument replicated there (a weight beside
    batch-sharded rows) gets on each rank only that rank's share of its
    gradient: its gradient is a pending sum (``Partial``) on that dim
    (a dim of one rank splits nothing)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = ref.device_mesh
    split = {i for pl in in_placements for i, p in enumerate(pl)
             if p.is_shard() and mesh.size(i) > 1}
    grads = tuple(tuple(_api().Partial() if i in split and p.is_replicate()
                        else p for i, p in enumerate(pl))
                  for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)


def _settled(t: torch.Tensor, want: List[Any],
             one: Optional[List[Any]] = None) -> List[Any]:
    """``want`` on the mesh dims of more than one rank; on a dim of one
    rank, where every placement holds the same local tensor, ``t``'s own
    placement (or ``one``'s): ``local_map`` then redistributes nothing
    there, which on the host costs as much as a small layer's op."""
    mesh = t.device_mesh
    one = one or t.placements
    return [o if mesh.size(d) == 1 else w
            for d, (o, w) in enumerate(zip(one, want))]


def _flat(params: dict, path: tuple = ()) -> List[tuple]:
    """(path, tensor) of every leaf of a nested dict, keys sorted."""
    out: List[tuple] = []
    for k in sorted(params):
        v = params[k]
        out += _flat(v, path + (k,)) if isinstance(v, dict) else \
            [(path + (k,), v)]
    return out


def _unzip(flat: List[tuple]) -> tuple:
    """(paths, tensors) of :func:`_flat`'s pairs."""
    return tuple(p for p, _ in flat), tuple(t for _, t in flat)


def _nest(paths: Sequence[tuple], values: Sequence[Any]) -> dict:
    """The nested dict :func:`_flat` flattened."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def on_batch_rows(fn, x: torch.Tensor, params: dict, states: tuple,
                  n_out: int):
    """``fn(params, x, *states)`` run on each rank's whole batch rows:
    ``x`` and the ``states`` batch-sharded as ``x`` is, every parameter
    (``params`` a dict of tensors, nested or not) gathered whole. ``fn``
    returns ``(y, (s1, s2, ...))``; this returns the same as
    ``DTensor``s, batch-sharded, ``n_out`` tensors in all. For
    recurrences that DTensor has no rules for (the SSM cells and scans),
    and for layers whose many small ops would each pay DTensor's dispatch
    on the host. A plain ``x`` is ``fn(params, x, *states)`` itself."""
    if not is_dtensor(x):
        return fn(params, x, *states)
    paths, leaves = _unzip(_flat(params))
    states = tuple(as_dtensor(s, x) for s in states)
    rows, rep = batch_only(x), replicated(x)

    def local(x, *flat):
        y, st = fn(_nest(paths, flat[:len(paths)]), x, *flat[len(paths):])
        return (y, *st)

    in_placements = [_settled(x, rows)] + [_settled(t, rep) for t in leaves] \
        + [_settled(t, rows) for t in states]
    out = on_local_shards(local, x, in_placements,
                          (_settled(x, rows),) * n_out)(x, *leaves, *states)
    return out[0], tuple(out[1:])


def on_all_rows(fn, x: torch.Tensor, params: dict, n_out: int):
    """``fn(params, x)`` run by every rank on the whole batch, for a layer
    that couples the batch's rows (an MoE layer's capacity and queue
    positions count every token): ``x`` and every parameter gathered
    whole. ``fn`` returns ``n_out`` tensors, y first; y comes back placed
    as ``x`` is (pending sums resolved), each rank keeping its rows, the
    rest replicated. A plain ``x`` is ``fn(params, x)`` itself."""
    if not is_dtensor(x):
        return fn(params, x)
    paths, leaves = _unzip(_flat(params))
    rep, placed = replicated(x), unreduced(x)
    y_at = _settled(x, rep, placed)
    out = on_local_shards(
        lambda x, *flat: tuple(fn(_nest(paths, flat), x)), x,
        [_settled(t, rep) for t in (x, *leaves)],
        (y_at,) + (rep,) * (n_out - 1))(x, *leaves)
    y = out[0] if y_at == placed else \
        out[0].redistribute(x.device_mesh, placed)
    return (y, *out[1:])


def batch_rows(n_out: int, stateful: bool = False):
    """Decorator for a layer ``fn(params, x, *rest)`` (``stateful``:
    ``fn(params, x, state, *rest)``, ``state`` a tuple) that runs whole
    on each rank's batch rows when ``x`` is a ``DTensor``
    (:func:`on_batch_rows`, ``n_out`` counting y and the returned
    state's tensors); plain tensors call ``fn`` directly."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(params, x, *rest, **kw):
            if not is_dtensor(x):
                return fn(params, x, *rest, **kw)
            if stateful:
                return on_batch_rows(
                    lambda p, x, *st: fn(p, x, st, *rest[1:], **kw), x,
                    params, tuple(rest[0]), n_out)
            return on_batch_rows(lambda p, x: fn(p, x, *rest, **kw), x,
                                 params, (), n_out)
        return run
    return wrap


def _vocab_slice(t: torch.Tensor, dim: int):
    """(the first index of this rank's slice of ``t``'s dim ``dim``, the
    mesh dims that split it): the slices are even, in mesh-dim order."""
    mesh = t.device_mesh
    split = [i for i, p in enumerate(t.placements)
             if p == _api().Shard(dim)]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    chunk, n_chunks = 0, 1
    for i in split:
        chunk = chunk * mesh.size(i) + coord[i]
        n_chunks *= mesh.size(i)
    return chunk * (t.shape[dim] // n_chunks), split


def pick_last(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``: each position's entry at its label, the
    labels already in range. On ``DTensor`` logits whose last dim is
    sharded (a vocab-parallel unembedding), each rank picks within its
    vocab slice (zero where the label lies outside it) and the slices
    are summed: the logits are never gathered."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    dt = _api()
    Shard, Replicate, Partial = dt.Shard, dt.Replicate, dt.Partial
    last = logits.ndim - 1
    offset, _ = _vocab_slice(logits, last)
    keep = [p if p in (Shard(last), Shard(0)) else Replicate()
            for p in logits.placements]
    rows = batch_only(logits)
    out = [Partial() if p == Shard(last) else p for p in keep]

    def local(lg, lb):
        loc = lb - offset
        inside = (loc >= 0) & (loc < lg.shape[-1])
        got = torch.gather(lg, -1, loc.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(inside, got[..., 0], torch.zeros_like(got[..., 0]))

    return on_local_shards(local, logits, (keep, rows), out)(
        logits, as_dtensor(labels, logits))


def vocab_gather(table: torch.Tensor, ids_of, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """``table[ids_of(tokens)]`` of a ``DTensor`` table (V, d): each rank
    gathers the rows of its vocab slice (zero rows for ids outside it)
    and the slices are summed (a vocab-parallel embedding). The table is
    whole in d and the tokens whole rows of their batch shard. DTensor's
    own rule for the gather's gradient (an accumulating ``index_put``)
    fails on some torch versions; this one is a local gather."""
    dt = _api()
    Shard, Replicate, Partial = dt.Shard, dt.Replicate, dt.Partial
    offset, split = _vocab_slice(table, 0)
    vocab = [Shard(0) if i in split else Replicate()
             for i in range(table.device_mesh.ndim)]
    tok = as_dtensor(tokens, table)
    rows = [Replicate() if v == Shard(0) else r
            for r, v in zip(batch_only(tok), vocab)]
    out = [Partial() if v == Shard(0) else r for r, v in zip(rows, vocab)]

    def local(t, tk):
        loc = ids_of(tk) - offset
        inside = ((loc >= 0) & (loc < t.shape[0]))[..., None]
        got = t[loc.clamp(0, t.shape[0] - 1)]
        return torch.where(inside, got, torch.zeros_like(got))

    return on_local_shards(local, table, (vocab, rows), out)(table, tok)

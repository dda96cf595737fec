"""Per-chip cost of one step, counted from the aten ops a rank runs on
its local shards.

The counterpart of ``repro/launch/hlo_analysis.py``. There is no HLO to
read: PyTorch runs eagerly and fuses nothing, so the step's cost is the
sum over the ops it dispatches. :class:`OpAnalyzer` is a dispatch mode
that records each op below DTensor's dispatch, where the op runs on a
rank's local tensors: for a ``DTensor`` operand it declines the op
(``NotImplemented``), DTensor then redistributes and runs the local op,
and that local op comes back to the mode. So every count is per chip,
on local shapes (``FlopCounterMode`` over DTensors counts global
shapes). Under ``FakeTensorMode`` nothing is allocated.

  * ``flops``: products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    convolutions) are 2 x output elements x the contracted size;
    elementwise ops and reductions count one per output (reductions: per
    input) element; data movement counts none. The hand-written kernels
    (``repro_torch::*`` ops) count their own arithmetic (:data:`KERNELS`).
  * ``bytes``: operands plus results of every op that launches work,
    since nothing is fused. An in-place write into part of a tensor
    (``index_put_``, ``scatter_``, ``copy_`` into a view, the KV-cache
    row write) is charged by the region written, read and written, not
    by the buffer. A loop-invariant weight is charged on every read: the
    reference discounts a ``while`` body's invariant carries to one pass
    (they stay in VMEM on its TPU); an eager step re-reads them from HBM
    each time, so this analyzer does not.
  * ``coll_bytes`` / ``coll_by_kind`` / ``coll_by_axis``: operand bytes
    of the ``_c10d_functional`` collectives DTensor issues, an
    all-reduce counted twice (ring: reduce-scatter plus all-gather), as
    in the reference; ``coll_by_axis`` splits them by the mesh axis of
    their group.
  * ``seq_iters``: kernel launches. Each op of an eager step is a
    dependent host dispatch, so launches times the host's per-launch
    cost (``roofline.Hardware.loop_latency``) is the step's serial
    floor, the port's form of the reference's loop-iteration count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    """One step's per-chip work (the reference's fields, plus
    ``coll_by_axis``)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    seq_iters: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_ops: List[Tuple[str, str, float, float]] = dataclasses.field(
        default_factory=list)   # (kind, shape_text, bytes, trip_mult)
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        """Add ``mult`` times ``other``."""
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        self.seq_iters += other.seq_iters * mult
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v * mult
        for k, v in other.coll_by_axis.items():
            self.coll_by_axis[k] = self.coll_by_axis.get(k, 0.0) + v * mult
        for kind, st, b, m in other.coll_ops:
            self.coll_ops.append((kind, st, b, m * mult))


def nbytes(t: Any) -> int:
    """Bytes of a tensor's elements (a view counts its own elements, not
    its storage); 0 for anything else."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors in a nested argument tree."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


# Ops that move no data and launch nothing: views, metadata, allocation.
_FREE = {
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "detach",
    "alias", "as_strided", "slice", "select", "unsqueeze", "squeeze",
    "split", "split_with_sizes", "chunk", "unbind", "unfold", "diagonal",
    "_reshape_alias", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_local_scalar_dense",
    "set_", "resize_", "_has_compatible_shallow_copy_type", "device",
    "layout", "wait_tensor", "record_stream", "_nested_tensor_from_mask",
    "is_contiguous", "stride", "size", "dim", "numel",
}
# Data movement: bytes, no arithmetic.
_MOVE = {
    "clone", "_to_copy", "copy", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "embedding", "repeat", "repeat_interleave",
    "constant_pad_nd", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "fill", "zero",
    "arange", "flip", "roll", "expand_copy", "select_backward",
    "slice_backward", "embedding_dense_backward", "lift_fresh_copy",
    "scalar_tensor", "_copy_from", "_copy_from_and_resize", "split_copy",
    "masked_select", "nonzero", "tril", "triu", "one_hot",
}
# In-place writes into part of ``self``: charged by the region written.
_REGION_WRITES = {"index_put", "_index_put_impl", "scatter", "scatter_add",
                  "scatter_reduce", "index_copy", "index_add",
                  "masked_scatter", "index_fill", "masked_fill"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "var",
               "var_mean", "std", "logsumexp", "_log_softmax",
               "_softmax", "prod", "norm", "linalg_vector_norm", "cumsum",
               "argmax", "argmin", "sort", "topk", "all", "any",
               "_log_softmax_backward_data", "_softmax_backward_data"}
# The functional collectives DTensor issues, by the reference's names.
_COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                     "all_gather_into_tensor": "all-gather",
                     "reduce_scatter_tensor": "reduce-scatter",
                     "all_to_all_single": "all-to-all"}


def _product_flops(name: str, args: Tuple[Any, ...],
                   out: List[torch.Tensor]) -> Optional[float]:
    """2 x output elements x contracted size of a product, None for any
    other op."""
    if name in ("mm", "bmm", "_scaled_mm"):
        return 2.0 * out[0].numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        return 2.0 * out[0].numel() * args[1].shape[-1]
    if name in ("convolution", "_convolution", "convolution_overrideable"):
        # weight (C_out, C_in / groups, *window): one output element
        # contracts C_in / groups x window inputs
        return 2.0 * out[0].numel() * math.prod(args[1].shape[1:])
    return None


def _live_pairs(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs a causal mask keeps: query i sees keys j <= i +
    q_offset (all sq * sk pairs without the mask)."""
    if not causal:
        return sq * sk
    full_from = max(0, min(sq, sk - q_offset))   # rows i with i+off+1 <= sk
    first = q_offset + 1
    partial = full_from * first + full_from * (full_from - 1) // 2
    return partial + (sq - full_from) * sk


def _flash_fwd_cost(args, out) -> Tuple[float, float]:
    """Flash forward: 2 B H (D + DV) per live pair (Q K^T over the q/k
    dim, P V over the value dim); q, k, v in, out (and lse) written."""
    q, k, v = args[0], args[1], args[2]
    b, h, sq, d = q.shape
    live = _live_pairs(sq, k.shape[2], bool(args[3]), int(args[4]))
    return (2.0 * b * h * (d + v.shape[3]) * live,
            sum(nbytes(t) for t in args[:3]) + sum(nbytes(t) for t in out))


def _flash_bwd_cost(args, out) -> Tuple[float, float]:
    """Flash backward: the probabilities recomputed and four more
    products, 2 B H (3 D + 2 DV) per live pair (S, dK and dQ over the q/k
    dim, dP and dV over the value dim: 10 B H D where they are equal); six
    inputs in, three gradients out."""
    q, k, v = args[0], args[1], args[2]
    b, h, sq, d = q.shape
    live = _live_pairs(sq, k.shape[2], bool(args[6]), int(args[7]))
    return (2.0 * b * h * (3 * d + 2 * v.shape[3]) * live,
            sum(nbytes(t) for t in args[:6]) + sum(nbytes(t) for t in out))


def _paged_cost(args, out) -> Tuple[float, float]:
    """Paged decode: each lane reads its table's pages (every position of
    the table, the whole cache; a fake run cannot read ``seq_lens``)."""
    q, k_pages, _, table = args[:4]
    b, h, d = q.shape
    ps, hk = k_pages.shape[1], k_pages.shape[2]
    length = table.shape[1] * ps
    page_bytes = 2 * b * length * hk * d * k_pages.element_size()
    return (4.0 * b * h * d * length,
            nbytes(q) + page_bytes + nbytes(table) + nbytes(args[4])
            + sum(nbytes(t) for t in out))


def _adamw_sum_squares_cost(args, out) -> Tuple[float, float]:
    """AdamW's norm pass: a multiply-add an element; each gradient read
    once."""
    grads = args[0]
    return (2.0 * sum(g.numel() for g in grads),
            sum(nbytes(g) for g in grads) + sum(nbytes(t) for t in out))


def _adamw_apply_cost(args, out) -> Tuple[float, float]:
    """AdamW's update pass: 15 flops an element (17 where it decays);
    parameters and moments read and written once, gradients read once."""
    params, grads, m, v, sumsq, count, decay = args[:7]
    flops = sum((17.0 if dk else 15.0) * p.numel()
                for p, dk in zip(params, decay))
    moved = sum(2 * nbytes(p) + nbytes(g) + 2 * nbytes(a) + 2 * nbytes(b)
                for p, g, a, b in zip(params, grads, m, v))
    return flops, moved + nbytes(sumsq) + nbytes(count) + sum(
        nbytes(t) for t in out)


#: Cost functions of the hand-written kernels' ops, by op name: (args,
#: outputs) -> (flops, bytes).
KERNELS: Dict[str, Callable[..., Tuple[float, float]]] = {
    "flash_attention_fwd": _flash_fwd_cost,
    "flash_attention_bwd": _flash_bwd_cost,
    "paged_attention": _paged_cost,
    "adamw_sum_squares": _adamw_sum_squares_cost,
    "adamw_apply": _adamw_apply_cost,
}


class _Paused:
    """A context that pauses an analyzer's counting; it stands in for
    DTensor's ``ShardingPropagator._fake_mode_lock`` (a no-op context
    meant for a lock), which wraps the op DTensor runs on global-shape
    fake tensors to learn an output's shape. That op is not part of the
    step."""

    def __init__(self, analyzer: "OpAnalyzer", lock: Any):
        self.analyzer = analyzer
        self.lock = lock

    def __enter__(self):
        """Pause, then take the lock it replaces."""
        self.analyzer._paused += 1
        return self.lock.__enter__()

    def __exit__(self, *exc):
        """Release the lock, resume counting."""
        try:
            return self.lock.__exit__(*exc)
        finally:
            self.analyzer._paused -= 1


class OpAnalyzer(TorchDispatchMode):
    """Counts one step's per-chip :class:`Cost` while active. ``mesh``
    (a ``DeviceMesh``) names the axis of each collective's group;
    ``record_ops`` keeps a per-op table (:meth:`op_table`)."""

    def __init__(self, mesh: Any = None, record_ops: bool = False):
        super().__init__()
        self._paused = 0
        self._saved_lock: Any = None
        self.cost = Cost()
        self.record_ops = record_ops
        self.ops: Dict[str, List[float]] = {}
        self.group_axis: Dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names or ()):
                self.group_axis[mesh.get_group(i).group_name] = name

    def __enter__(self):
        """Start counting; DTensor's shape inference is not counted where
        torch has the lock it takes for it (2.13 does; an older DTensor
        without it adds its first global-shape run of each op signature
        to the counts)."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._saved_lock = getattr(ShardingPropagator, "_fake_mode_lock",
                                   None)
        if self._saved_lock is not None:
            ShardingPropagator._fake_mode_lock = _Paused(self,
                                                         self._saved_lock)
        return super().__enter__()

    def __exit__(self, *exc):
        """Stop counting."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        try:
            return super().__exit__(*exc)
        finally:
            if self._saved_lock is not None:
                ShardingPropagator._fake_mode_lock = self._saved_lock

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        """Decline DTensor ops (DTensor then runs the local ops, which
        come back here); run and count every other op."""
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _record(self, name: str, flops: float, nbytes_: float) -> None:
        """Add one launch of ``name``."""
        self.cost.flops += flops
        self.cost.bytes += nbytes_
        self.cost.seq_iters += 1
        if self.record_ops:
            row = self.ops.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes_

    def _count(self, func, args, kwargs, out) -> None:
        """Charge one op."""
        ns = func.namespace
        name = func._schema.name.split("::", 1)[-1]
        base = name[:-1] if name.endswith("_") else name
        outs = _tensors(out)
        if ns == "prim" or base in _FREE:
            return
        if ns.startswith("_c10d_functional"):
            self._collective(func, base, args, outs)
            return
        if ns == "repro_torch" and base in KERNELS:
            flops, b = KERNELS[base](args, outs)
            self._record(f"{ns}.{name}", flops, b)
            return
        ins = _tensors((args, kwargs))
        in_bytes = sum(nbytes(t) for t in ins)
        out_bytes = sum(nbytes(t) for t in outs)
        full = f"{ns}.{name}"
        flops = _product_flops(base, args, outs)
        if flops is not None:
            self._record(full, flops, in_bytes + out_bytes)
            return
        inplace = name.endswith("_") or bool(
            func._schema.arguments and func._schema.arguments[0].alias_info
            and func._schema.arguments[0].alias_info.is_write)
        if base in _REGION_WRITES and inplace:
            # read and write the region: the operands other than self
            region = in_bytes - nbytes(args[0])
            self._record(full, 0.0, 2 * region)
            return
        if base == "copy" and inplace:
            self._record(full, 0.0, 2 * nbytes(args[1]))
            return
        if inplace:
            # self is among the operands and is written again
            out_bytes = nbytes(args[0])
        if base in _MOVE:
            self._record(full, 0.0, in_bytes + out_bytes)
            return
        if base in _REDUCTIONS:
            elems = sum(t.numel() for t in ins[:1])
            self._record(full, float(elems), in_bytes + out_bytes)
            return
        elems = sum(t.numel() for t in outs) if not inplace \
            else args[0].numel()
        self._record(full, float(elems), in_bytes + out_bytes)

    def _collective(self, func, base: str, args, outs) -> None:
        """Charge a functional collective: link bytes by kind and axis."""
        kind = _COLLECTIVE_KINDS.get(base)
        if kind is None:
            return
        opbytes = sum(nbytes(t) for t in _tensors(args[:1])) or \
            sum(nbytes(t) for t in outs)
        link = 2.0 * opbytes if kind == "all-reduce" else float(opbytes)
        group = next((a for a in args if isinstance(a, str)
                      and a in self.group_axis), None)
        axis = self.group_axis.get(group, "?")
        c = self.cost
        c.coll_bytes += link
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + link
        c.coll_by_axis[axis] = c.coll_by_axis.get(axis, 0.0) + link
        shape = tuple(args[0].shape) if isinstance(args[0], torch.Tensor) \
            else ()
        c.coll_ops.append((kind, str(shape), link, 1.0))
        self._record(f"{func.namespace}.{base}", 0.0,
                     opbytes + sum(nbytes(t) for t in outs))

    def op_table(self) -> List[Tuple[str, int, float, float]]:
        """(op, launches, flops, bytes) rows, most bytes first."""
        return sorted(((k, int(v[0]), v[1], v[2])
                       for k, v in self.ops.items()),
                      key=lambda r: -r[3])

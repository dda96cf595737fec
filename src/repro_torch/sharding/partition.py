"""Sharding rules: parameter, batch and decode-state partition specs over
a mesh, and their DTensor placements.

The port of ``repro/sharding/partition.py``. Parallelism:

  * TP (Megatron-style) over the ``model`` axis: attention QKV column- /
    O row-parallel, MLP in/out column/row, MoE expert-parallel (expert
    axis over ``model``), Mamba inner channels over ``model``,
    vocab-parallel embeddings.
  * DP over ``('pod', 'data')`` for batches.
  * FSDP (parameter and optimizer-state sharding) over the DP axes for
    models above ``fsdp_threshold`` parameters.

A rule whose dimension is not divisible by the mesh-axis size silently
degrades to replication for that dimension (internvl2's 92,553 vocab is
not divisible by 16, so its embedding stays replicated).

The rules are a pure function of a leaf's name, its shape and the mesh's
axis sizes. A mesh is a ``torch.distributed`` ``DeviceMesh`` (axis names
``mesh_dim_names``) or anything with ``axis_names`` and a ``shape``
mapping from name to size, such as ``launch.mesh.MeshShape``. A spec is
a :class:`PartitionSpec`: one entry per tensor dimension, each an axis
name, a tuple of axis names, or None. The port keeps one dict per layer
(``params["layers"][p * period + i]``), so a layer's spec is the
reference's stacked spec without its leading None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.train.tree import Tree, named_leaves, tree_map

Axes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``PartitionSpec(None,
    "model")`` shards dim 1 over ``model`` and replicates dim 0. Equal to
    the tuple of its entries."""

    def __new__(cls, *entries: Axes) -> "PartitionSpec":
        """A spec of ``entries``, one per tensor dimension."""
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        """``P(...)``, as the reference prints its specs."""
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Which mesh axes carry TP, DP and (when ``fsdp``) FSDP; ``seq_axes``
    shard a decode KV cache's sequence axis."""
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = False
    seq_axes: Tuple[str, ...] = ("model",)

    @property
    def fsdp_axes(self) -> Optional[Tuple[str, ...]]:
        """The DP axes when FSDP is on, else None."""
        return self.dp_axes if self.fsdp else None


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mesh-shaped object
    (``axis_names`` and a ``shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_names(mesh: Any) -> Tuple[str, ...]:
    """The mesh's axis names, in order."""
    return tuple(axis_sizes(mesh))


def make_policy(cfg: ModelConfig, mesh: Any,
                fsdp_threshold: float = 5e9) -> ShardingPolicy:
    """TP over ``model``, DP over whichever of ``pod`` and ``data`` the
    mesh has, FSDP above ``fsdp_threshold`` parameters."""
    dp = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    return ShardingPolicy(tp_axis="model", dp_axes=dp,
                          fsdp=cfg.param_count() > fsdp_threshold)


class RuleContext:
    """A mesh's axis sizes and a policy, for the rules' divisibility
    test."""

    def __init__(self, mesh: Any, policy: ShardingPolicy):
        self.mesh = mesh
        self.policy = policy
        self.sizes = axis_sizes(mesh)

    def size(self, axes: Axes) -> int:
        """Product of the sizes of ``axes`` (1 for None)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def fit(self, axes: Axes, dim: int) -> Axes:
        """``axes`` if they evenly divide ``dim``, else None
        (replicate)."""
        if axes is None or dim % self.size(axes) != 0:
            return None
        return axes


def _param_spec(path: str, shape: Sequence[int],
                ctx: RuleContext) -> PartitionSpec:
    """The spec of one unstacked parameter, by its leaf name and shape."""
    tp = ctx.policy.tp_axis
    f = ctx.policy.fsdp_axes
    leaf = path.rsplit("/", 1)[-1]
    fit = ctx.fit

    if leaf == "table":                               # embed/unembed/head
        return P(fit(tp, shape[0]), fit(f, shape[1]))
    if leaf in ("wq", "wk", "wv"):
        return P(fit(f, shape[0]), fit(tp, shape[1]))
    if leaf in ("bq", "bk", "bv"):
        return P(fit(tp, shape[0]))
    if leaf == "wo":
        return P(fit(tp, shape[0]), fit(f, shape[1]))
    if leaf == "router":
        return P(fit(f, shape[0]), None)
    # Latent attention: the latent and the shared RoPE key are every
    # head's (columns whole), the per-head up-projection splits by head.
    if leaf == "wkv_a":
        return P(fit(f, shape[0]), None)
    if leaf == "wkv_b":
        return P(fit(f, shape[0]), fit(tp, shape[1]))
    if leaf in ("w_in", "w_gate"):
        if len(shape) == 3:                           # MoE (E, d, de)
            return P(fit(tp, shape[0]), fit(f, shape[1]), None)
        return P(fit(f, shape[0]), fit(tp, shape[1]))
    if leaf == "w_out":
        if len(shape) == 3:                           # MoE (E, de, d)
            return P(fit(tp, shape[0]), None, fit(f, shape[2]))
        return P(fit(tp, shape[0]), fit(f, shape[1]))
    if leaf in ("sh_in", "sh_gate"):
        return P(fit(f, shape[0]), fit(tp, shape[1]))
    if leaf == "sh_out":
        return P(fit(tp, shape[0]), fit(f, shape[1]))
    # Mamba.
    if leaf == "conv_w":
        return P(None, fit(tp, shape[1]))
    if leaf in ("conv_b", "dt_bias", "D"):
        return P(fit(tp, shape[0]))
    if leaf in ("w_dt_down", "w_bc", "A_log"):
        return P(fit(tp, shape[0]), None)
    if leaf == "w_dt_up":
        return P(None, fit(tp, shape[1]))
    # xLSTM.
    if leaf == "w_up":
        return P(fit(f, shape[0]), fit(tp, shape[1]))
    if leaf in ("w_gates", "r_gates"):
        return P(None, fit(tp, shape[1]))
    if leaf == "g_bias":
        return P(fit(tp, shape[0]))
    if leaf == "w_if":
        return P(fit(tp, shape[0]), None)
    if leaf == "if_bias":
        return P(None)
    if leaf == "w_down":
        return P(fit(tp, shape[0]), fit(f, shape[1]))
    # Norm scales/biases and anything unmatched: replicate.
    return P(*([None] * len(shape)))


def _map_named(fn, tree: Tree) -> Tree:
    """``fn(path, leaf)`` over ``tree``'s leaves, in its structure."""
    it = iter([fn(name, leaf) for name, leaf in named_leaves(tree)])
    return tree_map(lambda _: next(it), tree)


def param_specs(params: Tree, mesh: Any,
                policy: ShardingPolicy) -> Tree:
    """The spec of every parameter leaf (tensors, fake tensors or anything
    with a ``shape``), in the parameters' structure."""
    ctx = RuleContext(mesh, policy)
    return _map_named(lambda path, leaf: _param_spec(path, leaf.shape, ctx),
                      params)


def batch_spec(mesh: Any, policy: ShardingPolicy, batch: int,
               extra_dims: int = 1) -> PartitionSpec:
    """Shard the batch dim over the DP axes when divisible."""
    b_axes = RuleContext(mesh, policy).fit(policy.dp_axes, batch)
    return P(b_axes, *([None] * extra_dims))


def decode_state_specs(state: Tree, mesh: Any, policy: ShardingPolicy,
                       batch: int, seq_axes: Tuple[str, ...]) -> Tree:
    """Decode-state specs of the port's per-layer state (lane on axis 0):
    KV caches (B, S, Hk, Dh) shard B over DP and S over ``seq_axes``;
    Mamba's state and conv window shard their channel axis over TP when
    divisible; every other state shards B alone."""
    ctx = RuleContext(mesh, policy)
    b_axes = ctx.fit(policy.dp_axes, batch)
    tp = policy.tp_axis

    def one(path: str, leaf: Any) -> PartitionSpec:
        shape = leaf.shape
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):                        # (B, S, Hk, Dh)
            return P(b_axes, ctx.fit(seq_axes, shape[1]), None, None)
        if name == "h" and len(shape) == 3:           # mamba (B, di, ds)
            return P(b_axes, ctx.fit(tp, shape[1]), None)
        if name == "conv":                            # (B, dc-1, di)
            return P(b_axes, None, ctx.fit(tp, shape[2]))
        if len(shape) >= 1:
            return P(b_axes, *([None] * (len(shape) - 1)))
        return P()

    return _map_named(one, state)


def to_placements(spec: PartitionSpec, mesh: Any) -> List[Any]:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d names its axis (a dim over two axes,
    FSDP's ``("pod", "data")``, is ``Shard(d)`` on both), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    owner: Dict[str, int] = {}
    for d, axes in enumerate(spec):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate()
            for a in axis_names(mesh)]


def is_spec(x: Any) -> bool:
    """True for a :class:`PartitionSpec` (a leaf of a spec tree, though a
    tuple)."""
    return isinstance(x, PartitionSpec)


def tree_shardings(spec_tree: Tree, mesh: Any) -> Tree:
    """Placements of every spec in ``spec_tree``."""
    return tree_map(lambda s: to_placements(s, mesh), spec_tree,
                    is_leaf=is_spec)


def param_shardings(params: Tree, mesh: Any,
                    policy: ShardingPolicy) -> Tree:
    """Placements of every parameter on ``mesh``, in the parameters'
    structure."""
    return tree_shardings(param_specs(params, mesh, policy), mesh)


def place(t: Any, spec: PartitionSpec, mesh: Any) -> Any:
    """``t`` as a ``DTensor`` on ``mesh`` placed by ``spec``. Every rank
    holds the whole ``t`` already (the same seed, or a fake tensor), so
    no data moves between ranks: each keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, to_placements(spec, mesh),
                             src_data_rank=None)


def place_tree(tree: Tree, specs: Tree, mesh: Any) -> Tree:
    """Every leaf of ``tree`` placed by its spec in ``specs``."""
    return tree_map(lambda t, s: place(t, s, mesh), tree, specs)

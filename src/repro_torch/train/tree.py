"""Nested dicts, lists and tuples of tensors (the port's parameter and
optimizer-state trees), flattened and mapped in the order JAX flattens a
pytree: dict keys sorted, sequences in order."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _children(tree: Tree):
    """(keys, children) of an inner node; None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return list(range(len(tree))), list(tree)
    return None


def named_leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs; a path joins the keys and indices with "/", as
    the reference's checkpoint names its leaves."""
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    out = []
    for key, child in zip(*node):
        out.extend(named_leaves(child, f"{prefix}/{key}" if prefix
                                else str(key)))
    return out


def leaves(tree: Tree) -> List[Any]:
    """Every leaf, in flattening order."""
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf to trees of one structure."""
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    keys, kids = node
    mapped = [tree_map(fn, kid, *(r[k] for r in rest))
              for k, kid in zip(keys, kids)]
    if isinstance(tree, dict):
        return dict(zip(keys, mapped))
    return type(tree)(mapped)

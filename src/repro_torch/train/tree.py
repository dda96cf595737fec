"""Nested dicts, lists and tuples of tensors (the port's parameter and
optimizer-state trees), flattened and mapped in the order JAX flattens a
pytree: dict keys sorted, sequences in order."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Tree = Any
IsLeaf = Optional[Callable[[Any], bool]]


def _children(tree: Tree, is_leaf: IsLeaf = None):
    """(keys, children) of an inner node; None for a leaf (or for a node
    that ``is_leaf`` calls one)."""
    if is_leaf is not None and is_leaf(tree):
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return list(range(len(tree))), list(tree)
    return None


def named_leaves(tree: Tree, prefix: str = "",
                 is_leaf: IsLeaf = None) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs; a path joins the keys and indices with "/", as
    the reference's checkpoint names its leaves."""
    node = _children(tree, is_leaf)
    if node is None:
        return [(prefix, tree)]
    out = []
    for key, child in zip(*node):
        out.extend(named_leaves(child, f"{prefix}/{key}" if prefix
                                else str(key), is_leaf))
    return out


def leaves(tree: Tree, is_leaf: IsLeaf = None) -> List[Any]:
    """Every leaf, in flattening order."""
    return [leaf for _, leaf in named_leaves(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree,
             is_leaf: IsLeaf = None) -> Tree:
    """``fn`` applied leaf by leaf to trees of one structure; a node that
    ``is_leaf`` calls one is passed to ``fn`` whole."""
    node = _children(tree, is_leaf)
    if node is None:
        return fn(tree, *rest)
    keys, kids = node
    mapped = [tree_map(fn, kid, *(r[k] for r in rest), is_leaf=is_leaf)
              for k, kid in zip(keys, kids)]
    if isinstance(tree, dict):
        return dict(zip(keys, mapped))
    return type(tree)(mapped)


def without(tree: Tree, names) -> Tree:
    """``tree`` with every dict entry whose key is in ``names`` left out
    (new dicts and lists, the same leaves)."""
    if isinstance(tree, dict):
        return {k: without(v, names) for k, v in tree.items()
                if k not in names}
    if isinstance(tree, (list, tuple)):
        return type(tree)(without(v, names) for v in tree)
    return tree

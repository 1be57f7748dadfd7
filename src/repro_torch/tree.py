"""Parameter and state trees: nested dicts, lists and tuples of tensors.

The port keeps the JAX package's pytrees as plain containers, so these two
helpers stand in for ``jax.tree_util.tree_map`` and ``tree_leaves``. Dict
leaves are visited in insertion order (JAX sorts dict keys; nothing here
depends on the order).
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]

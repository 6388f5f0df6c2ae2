"""Nested dicts of tensors: the port's pytrees.

The reference's parameters, optimiser state and checkpoints are JAX
pytrees of dicts; the port keeps the same nesting as plain dicts.  A leaf
is anything that is not a `Mapping`.  `tree_items` walks the keys of each
dict in sorted order, the order ``jax.tree_util`` flattens dicts in, so
sums over leaves and checkpoint manifests follow the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def tree_items(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...],
                                                               Any]]:
    """``[(path, leaf)]`` in the reference's (sorted-key) order."""
    if isinstance(tree, Mapping):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], path + (str(k),))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (in `tree_leaves` order) in place
    of its own."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            out = dict.fromkeys(t)
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        return next(it)

    return build(tree)

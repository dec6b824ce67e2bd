"""Trees of tensors in ``jax.tree``'s leaf order.

The training state is nested dicts, tuples and NamedTuples (``OptState``)
of tensors, as in the JAX package.  Checkpoints name leaves by their
position, so both packages must walk a tree in the same order:
``jax.tree.flatten``'s.  That order is: dict keys sorted as strings (so
``"b10"`` comes before ``"b2"``), tuple and NamedTuple fields in order,
``None`` an empty subtree, anything else a leaf.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["flatten", "leaves", "tree_map"]


def flatten(tree, is_leaf: Callable | None = None) -> tuple:
    """(leaves, unflatten): the leaves in ``jax.tree.flatten``'s order and a
    function that builds a tree of the same structure from new leaves."""
    out: list = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            out.append(t)
            return lambda it: next(it)
        if t is None:
            return lambda it: None
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (tuple, list)):
            subs = [walk(x) for x in t]
            if hasattr(t, "_fields"):  # NamedTuple
                return lambda it: type(t)(*(s(it) for s in subs))
            return lambda it: type(t)(s(it) for s in subs)
        out.append(t)
        return lambda it: next(it)

    build = walk(tree)

    def unflatten(new_leaves):
        new_leaves = list(new_leaves)
        if len(new_leaves) != len(out):
            raise ValueError(f"{len(new_leaves)} leaves for a tree of {len(out)}")
        return build(iter(new_leaves))

    return out, unflatten


def leaves(tree, is_leaf: Callable | None = None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order."""
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` and of trees of the same structure."""
    flat, unflatten = flatten(tree, is_leaf)
    others = [flatten(t, is_leaf)[0] for t in rest]
    return unflatten(fn(*xs) for xs in zip(flat, *others))

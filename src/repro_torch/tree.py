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


def _none(it):
    return None


def _walk(t, out: list, is_leaf):
    """Append ``t``'s leaves to ``out`` and return the function that builds
    ``t``'s structure from an iterator of leaves.  A module-level function:
    a nested one that called itself would sit in a reference cycle with
    ``out``, keeping every leaf alive until the garbage collector ran (a
    train step's grads, 8.6 GB for deepseek's 3-layer cut, piled up)."""
    if is_leaf is not None and is_leaf(t):
        out.append(t)
        return next
    if t is None:
        return _none
    if isinstance(t, dict):
        keys = sorted(t)
        subs = [_walk(t[k], out, is_leaf) for k in keys]
        return lambda it: {k: s(it) for k, s in zip(keys, subs)}
    if isinstance(t, (tuple, list)):
        subs = [_walk(x, out, is_leaf) for x in t]
        typ = type(t)
        if hasattr(t, "_fields"):  # NamedTuple
            return lambda it: typ(*(s(it) for s in subs))
        return lambda it: typ(s(it) for s in subs)
    out.append(t)
    return next


def flatten(tree, is_leaf: Callable | None = None) -> tuple:
    """(leaves, unflatten): the leaves in ``jax.tree.flatten``'s order and a
    function that builds a tree of the same structure from new leaves."""
    out: list = []
    build = _walk(tree, out, is_leaf)

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

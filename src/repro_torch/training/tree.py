"""Pytrees of tensors in ``jax.tree``'s order, without JAX.

A tree is a dict (children in SORTED key order, as ``jax.tree.flatten``
takes them), a NamedTuple (fields in order), a tuple or list (in order),
``None`` (an empty subtree: no leaf) or a leaf (anything else: a tensor,
a numpy array, a Python number).  The same order on both sides is what
lets a checkpoint written by either package restore in the other.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list | None:
    """The node's children in flattening order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if hasattr(node, "_fields"):                 # NamedTuple
        return type(node)(*children)
    return type(node)(children)


def leaves(tree) -> list:
    """The tree's leaves in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (an iterable of exactly as many)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(kid) for kid in kids])

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` on each leaf of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *cols)])

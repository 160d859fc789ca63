"""Walks over the port's parameter and optimizer trees in the order of
``jax.tree.leaves``: dict keys sorted, tuples and lists (a ``NamedTuple``
such as ``OptState`` among them) in order, None an empty subtree.  The
optimizer's clip norm sums its leaves in this order, and a checkpoint stores
them in it, so that both packages agree leaf for leaf."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for child in tree for x in leaves(child)]
    return [tree]


def unflatten(like: Any, values) -> Any:
    """A tree of ``like``'s structure whose leaves, in ``leaves`` order, are
    taken from ``values``."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}          # keep the key order
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in a tree of ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])

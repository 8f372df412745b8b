"""Nested dicts of tensors as pytrees, in ``jax.tree``'s leaf order.

``jax.tree.flatten`` walks a dict by sorted key, so index i of a flat
gradient names the same parameter in both packages only if the port
flattens the same way.  Everything here walks sorted keys, recursively.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in sorted-key order (empty dicts have none)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for key in sorted(tree) for x in leaves(tree[key])]


def unflatten(tree, values: Iterable[Any]) -> Dict[str, Any]:
    """A tree shaped like ``tree`` whose leaves are ``values``, in the
    order :func:`leaves` gives."""
    it = iter(values)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        return {key: build(t[key]) for key in sorted(t)}

    return build(tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of same-shaped trees."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest))])

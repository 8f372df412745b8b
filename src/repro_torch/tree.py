"""Nested dicts (and lists) of tensors as pytrees, in ``jax.tree``'s leaf
order.

``jax.tree.flatten`` walks a dict by sorted key and a list in order, so
index i of a flat gradient names the same parameter in both packages only
if the port flattens the same way.  Everything here walks sorted keys and
list positions, recursively.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

import torch


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in sorted-key order, lists in order (empty
    dicts and lists have none)."""
    if isinstance(tree, list):
        return [x for sub in tree for x in leaves(sub)]
    if not isinstance(tree, dict):
        return [tree]
    return [x for key in sorted(tree) for x in leaves(tree[key])]


def unflatten(tree, values: Iterable[Any]):
    """A tree shaped like ``tree`` whose leaves are ``values``, in the
    order :func:`leaves` gives."""
    it = iter(values)

    def build(t):
        if isinstance(t, list):
            return [build(sub) for sub in t]
        if not isinstance(t, dict):
            return next(it)
        return {key: build(t[key]) for key in sorted(t)}

    return build(tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of same-shaped trees."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest))])


def map_with_path(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of same-shaped
    trees, ``path`` the dict keys from the root to the leaf as strings.  A
    list's positions are not part of the path (as the reference's sharding
    rules read it: they skip sequence keys)."""
    if isinstance(tree, list):
        return [map_with_path(fn, *subs, path=path)
                for subs in zip(tree, *rest)]
    if not isinstance(tree, dict):
        return fn(path, tree, *rest)
    return {key: map_with_path(fn, tree[key], *(r[key] for r in rest),
                               path=path + (str(key),))
            for key in sorted(tree)}


def ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """``jax.flatten_util.ravel_pytree`` for a tree of tensors: the leaves,
    flattened and concatenated in :func:`leaves` order, and ``unravel``,
    which maps a flat vector back to a tree of views of it.  ``unravel``
    also takes a stack of flat vectors, (D, n), and returns a tree whose
    leaves carry that leading axis."""
    flat_leaves = leaves(tree)
    shapes = [tuple(l.shape) for l in flat_leaves]
    sizes = [l.numel() for l in flat_leaves]
    flat = torch.cat([l.reshape(-1) for l in flat_leaves])

    def unravel(v):
        lead = tuple(v.shape[:-1])
        return unflatten(tree, [part.reshape(lead + sh) for part, sh in
                                zip(torch.split(v, sizes, dim=-1), shapes)])

    return flat, unravel

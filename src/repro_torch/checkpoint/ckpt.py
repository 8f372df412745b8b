"""Minimal pytree checkpointing (npz + json list of tree paths).

Counterpart of ``repro/checkpoint/ckpt.py``, in its file format: one
``{name}.npz`` of the leaves keyed by tree path, and ``{name}.paths.json``,
the list of those keys in leaf order.  A key is the dict keys and list
indices from the root joined by ``/`` (``unit/p0/attn/wq``, ``conv/3/w``),
which is what the reference's ``_path_str`` makes of jax's ``DictKey`` and
``SequenceKey``; dicts are walked by sorted key, as ``jax.tree`` walks
them.  So a file written by either package restores in the other.  bf16
leaves are stored as f32, which is lossless.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import unflatten


def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dicts and lists, in
    :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(str(i), sub) for i, sub in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _walk(sub, f"{prefix}/{key}" if prefix else key)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree: Any, directory: str, name: str = "ckpt") -> str:
    """Write ``tree``'s leaves to ``directory/{name}.npz`` and their keys to
    ``directory/{name}.paths.json``; returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in _walk(tree)}
    npz_path = os.path.join(directory, f"{name}.npz")
    np.savez(npz_path, **flat)
    with open(os.path.join(directory, f"{name}.paths.json"), "w") as f:
        json.dump(list(flat), f)
    return npz_path


def restore_pytree(template: Any, directory: str, name: str = "ckpt",
                   device="cuda") -> Any:
    """A tree shaped like ``template`` (dicts and lists of tensors) whose
    leaves are read from ``directory/{name}.npz`` and cast to the template
    leaf's dtype, on ``device``.  The template's leaves may be meta
    tensors; a stored shape that differs from the template's raises
    ``ValueError``."""
    dev = resolve_device(device)

    def load(key, leaf):
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: stored shape {arr.shape} != template "
                             f"shape {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)

    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        return unflatten(template, [load(key, leaf)
                                    for key, leaf in _walk(template)])

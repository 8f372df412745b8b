"""Carry the reference package's params across into the port.

The port keeps the reference's param layout (see ``models/transformer.py``),
so the conversion is a checked tree map: every leaf the port expects must be
present with the same shape, and nothing else may be.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_params


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a private copy


def _convert(tree, expected, device, path: str) -> Dict[str, Any]:
    if not isinstance(tree, dict):
        raise ValueError(f"{path or 'params'}: expected a dict, got "
                         f"{type(tree).__name__}")
    if set(tree) != set(expected):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                         f"expected {sorted(expected)}")
    out = {}
    for key, want in expected.items():
        where = f"{path}.{key}" if path else key
        if isinstance(want, dict):
            out[key] = _convert(tree[key], want, device, where)
            continue
        shape = tuple(np.shape(tree[key]))
        if shape != tuple(want.shape):
            raise ValueError(f"{where}: shape {shape} != expected "
                             f"{tuple(want.shape)}")
        out[key] = _to_tensor(tree[key], device)
    return out


def params_from_jax(tree_of_numpy, cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """Port params from the reference's params as numpy arrays.

    ``tree_of_numpy`` is ``jax.tree.map(np.asarray, params)`` for params made
    by ``repro.models.transformer.init_params`` for the same config: for
    qwen2 ``embed (V, d)``, ``final_norm.scale``, ``unit.p0.{attn.{wq, wk,
    wv, wo, bq, bk, bv}, mlp.{w_gate, w_up, w_down}, norm1.scale,
    norm2.scale}`` with the layer stack on axis 0, and an empty ``rest``.
    Dtypes are kept.
    """
    dev = resolve_device(device)
    expected = init_params(None, cfg, device="meta")
    return _convert(tree_of_numpy, expected, dev, "")


def sgdm_state_from_jax(state_of_numpy, cfg: ModelConfig,
                        device="cuda") -> Dict[str, Any]:
    """Port a ``sgdm_init`` state, ``{"mom": <tree shaped like the
    params>}``, with the same checks as :func:`params_from_jax`."""
    return {"mom": params_from_jax(state_of_numpy["mom"], cfg, device)}


def cache_from_jax(cache_of_numpy, device="cuda") -> Dict[str, Any]:
    """Port a decode cache from the reference's, as numpy arrays.

    ``cache_of_numpy`` is ``jax.tree.map(np.asarray, cache)`` for a cache
    of ``repro.models.decode`` (``init_cache``, ``init_slot_cache`` or
    ``init_paged_cache``, filled or not): ``unit``/``rest`` layer dicts of
    ``k``/``v`` (and, paged, the int32 block table ``bt``) and ``pos``.  The
    port keeps that layout, so this is a checked copy: dtypes are kept and
    each leaf is a private tensor on ``device``.
    """
    dev = resolve_device(device)
    if not isinstance(cache_of_numpy, dict) or set(cache_of_numpy) != {
            "unit", "rest", "pos"}:
        raise ValueError("a decode cache is a dict of unit, rest and pos")

    def conv(tree, path):
        if isinstance(tree, dict):
            return {k: conv(v, f"{path}.{k}") for k, v in tree.items()}
        if np.ndim(tree) == 0 and path != "pos":
            raise ValueError(f"{path}: expected an array")
        return _to_tensor(tree, dev)

    return {key: conv(cache_of_numpy[key], key) for key in cache_of_numpy}

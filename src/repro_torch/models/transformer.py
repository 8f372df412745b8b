"""Model assembly for the serving slice: run context, stack plan, params.

Counterpart of ``repro/models/transformer.py``.  Params keep the reference's
pytree layout as nested dicts of tensors: ``embed``, ``final_norm``, an
optional ``lm_head``, ``unit`` (the repeating unit of the stack plan, each
leaf stacked over its repeats on axis 0) and ``rest`` (remainder layers).
Where the reference scans over the stacked unit, the port walks it with a
Python loop.

This slice ports attention blocks with dense FFNs (the ``dense`` family:
qwen2, qwen1.5, internlm2, mistral-large); every other family or block kind
raises ``NotImplementedError`` naming the ROADMAP item that will port it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN_FULL, ATTN_LOCAL, ATTN_SWA, MLSTM,
                                      SLSTM, ModelConfig)
from repro_torch.models import layers as L

ATTN_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL)

# ---------------------------------------------------------------------------
# run context


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Execution context: dtypes, attention tiling, kernel dispatch, device.

    ``prefill_backend``/``decode_backend``: ``"kernel"`` routes attention
    through the Hopper kernels (their plain versions on CPU tensors),
    ``"torch"`` through the plain versions everywhere — the reference's
    ``"pallas"``/``"jax"``.  ``chunk_q``/``chunk_k`` mirror the reference's
    fields and are unused by the port: the kernel picks its own tiles and
    the plain version takes none.
    """
    chunk_q: int = 512
    chunk_k: int = 512
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    decode_backend: str = "kernel"
    prefill_backend: str = "kernel"
    device: str = "cuda"


# ---------------------------------------------------------------------------
# stack plan


def layer_sigs(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Per-layer (kind, ffn_kind) signatures from the *training* pattern."""
    sigs = []
    for li, kind in enumerate(cfg.pattern):
        if kind in (SLSTM, MLSTM) or cfg.d_ff == 0:
            ffn = "none"
        elif cfg.moe is not None and li % cfg.moe.layer_step == cfg.moe.layer_step - 1:
            ffn = "moe"
        elif cfg.moe is not None and cfg.moe.dense_d_ff:
            ffn = "dense_alt"
        else:
            ffn = "dense"
        sigs.append((kind, ffn))
    return sigs


def stack_plan(sigs: Sequence[Tuple[str, str]]) -> Tuple[int, int, int]:
    """-> (unit_len, repeats, remainder). Smallest unit with >=2 repeats."""
    n = len(sigs)
    for u in range(1, n // 2 + 1):
        k = n // u
        if all(sigs[i] == sigs[i % u] for i in range(u * k)):
            return u, k, n - u * k
    return n, 1, 0


_NOT_PORTED = ("ROADMAP.md, 'Modules to port': the serving model zoo "
               "(MoE, recurrent, xLSTM, whisper and VLM blocks)")


def check_supported(cfg: ModelConfig,
                    pattern: Optional[Sequence[str]] = None) -> None:
    """Raise ``NotImplementedError`` unless this slice serves ``cfg``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({_NOT_PORTED})")
    kinds = set(pattern if pattern is not None else cfg.pattern)
    for kind, ffn in layer_sigs(cfg):
        kinds.add(kind)
        if ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: FFN kind {ffn!r} is not ported yet "
                f"({_NOT_PORTED})")
    for kind in kinds:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"({_NOT_PORTED})")


# ---------------------------------------------------------------------------
# block init / norms


def _init_norm(cfg: ModelConfig, dtype, device):
    return {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def _norm(p, x, cfg: ModelConfig):
    if "bias" in p:
        return L.layer_norm(x, p["scale"], p["bias"], eps=1e-5)
    return L.rms_norm(x, p["scale"], eps=cfg.norm_eps)


def init_block(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    """One attention block with a dense FFN."""
    return {
        "norm1": _init_norm(cfg, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "norm2": _init_norm(cfg, dtype, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def take(tree: Dict[str, Any], r: int) -> Dict[str, Any]:
    """Repeat ``r`` of a stacked tree: every leaf indexed on axis 0 (views)."""
    return {k: take(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# model init


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Random params from ``gen`` (on ``device``), in the reference layout.

    ``device="meta"`` (with ``gen=None``) gives the shapes without storage.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    sigs = layer_sigs(cfg)
    u, reps, rem = stack_plan(sigs)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.padded_vocab_size, cfg.d_model, dtype,
                              dev),
        "final_norm": _init_norm(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                         cfg.padded_vocab_size, dtype, dev)
    params["unit"] = {
        f"p{j}": _stack([init_block(gen, cfg, dtype, dev)
                         for _ in range(reps)])
        for j in range(u)}
    params["rest"] = {f"l{u * reps + i}": init_block(gen, cfg, dtype, dev)
                      for i in range(rem)}
    return params

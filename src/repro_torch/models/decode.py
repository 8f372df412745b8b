"""Serving: fixed-slot KV caches, slot ops, fused prefill and decode step.

Counterpart of ``repro/models/decode.py`` for attention stacks with
contiguous caches (paged caches, ``ChunkedPrefill``, cross-attention and the
recurrent/xLSTM states come with later slices).

Cache kinds per layer, sized from the *effective* pattern:

* full attention — (b, S, kv, hd) K/V, slot = pos
* SWA / local    — ring buffer (b, W, kv, hd), slot = pos % W; RoPE is
  applied at write time, so the ring's storage order is harmless

The cache is the reference's dict: ``unit`` (each leaf stacked over the
unit's repeats), ``rest`` and ``pos`` — a scalar for an offline batch that
advances in lockstep, a (b,) vector of per-slot lengths for continuous
batching (``init_slot_cache``/``slot_insert``/``slot_evict``).

Unlike the reference, which is functional, these functions write the K/V
caches in place (a decode step touches one row per slot, and copying the
whole cache per step would double its memory traffic) and return the same
dict with ``pos`` advanced.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN_FULL, ATTN_LOCAL, ATTN_SWA, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.transformer import (RunCtx, _norm, check_supported,
                                            layer_sigs, stack_plan, take)


def _effective(cfg: ModelConfig, pattern, li):
    kind = pattern[li]
    window = cfg.window_size
    if cfg.pattern[li] == ATTN_FULL and kind == ATTN_SWA:
        window = cfg.long_context_variant_window
    return kind, window


def _attn_cache_shape(cfg: ModelConfig, batch: int, cache_len: int,
                      kind: str, window: int):
    S = cache_len if kind == ATTN_FULL else min(window, cache_len)
    return (batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)


def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int, kind: str,
                     window: int, dtype, device, reps: int = 0):
    """Zero K/V for one attention layer (``reps`` > 0: stacked over them)."""
    sh = _attn_cache_shape(cfg, batch, cache_len, kind, window)
    if reps:
        sh = (reps,) + sh
    return {"k": torch.zeros(sh, dtype=dtype, device=device),
            "v": torch.zeros(sh, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: RunCtx,
               pattern: Optional[Sequence[str]] = None):
    """Full decode cache dict, mirroring the stack plan layout."""
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    check_supported(cfg, pattern)
    dev = resolve_device(ctx.device)
    u, reps, rem = stack_plan(layer_sigs(cfg))
    cache: Dict[str, Any] = {"unit": {}, "rest": {}}
    for j in range(u):
        kind, window = _effective(cfg, pattern, j)
        cache["unit"][f"p{j}"] = init_layer_cache(
            cfg, batch, cache_len, kind, window, ctx.param_dtype, dev, reps)
    for i in range(rem):
        li = u * reps + i
        kind, window = _effective(cfg, pattern, li)
        cache["rest"][f"l{li}"] = init_layer_cache(
            cfg, batch, cache_len, kind, window, ctx.param_dtype, dev)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def init_slot_cache(cfg: ModelConfig, max_batch: int, cache_len: int,
                    ctx: RunCtx, pattern: Optional[Sequence[str]] = None):
    """Continuous-batching cache: ``max_batch`` fixed slots, per-slot lengths.

    Same layout as ``init_cache`` except ``pos`` is a (max_batch,) int32
    vector, so one ``decode_step`` serves a mixed-age batch.
    """
    cache = init_cache(cfg, max_batch, cache_len, ctx, pattern=pattern)
    cache["pos"] = torch.zeros((max_batch,), dtype=torch.int32,
                               device=cache["pos"].device)
    return cache


def slot_insert(cache, slot: int, src, src_slot: int = 0):
    """Copy one request's state out of ``src`` into ``cache`` slot ``slot``.

    ``src`` is a cache of the same config and cache_len, typically the
    batch-1 output of ``prefill_cache``.  Every per-slot leaf is
    overwritten, so the slot's previous occupant needs no cleanup.
    """
    for j, cl in cache["unit"].items():
        for name, dst in cl.items():
            dst[:, slot] = src["unit"][j][name][:, src_slot]
    for i, cl in cache["rest"].items():
        for name, dst in cl.items():
            dst[slot] = src["rest"][i][name][src_slot]
    cache["pos"][slot] = src["pos"].reshape(-1)[src_slot]
    return cache


def slot_evict(cache, slot: int):
    """Release ``slot``: zero its K/V and reset its length.

    A freed slot keeps riding the batched step (its logits are ignored): at
    ``pos`` 0 it reads one zeroed entry, masked by its kv_len of 1.
    """
    for cl in cache["unit"].values():
        for dst in cl.values():
            dst[:, slot] = 0
    for cl in cache["rest"].values():
        for dst in cl.values():
            dst[slot] = 0
    cache["pos"][slot] = 0
    return cache


# ---------------------------------------------------------------------------
# decode


def _step_index(pos, S: int, b: int):
    """Where one decode step writes and reads a cache of length ``S``: the
    write slot ``pos % S`` (full cache: pos < S so slot == pos; ring: wraps),
    the (b,) int32 ``kv_len = min(pos + 1, S)``, and for per-slot ``pos`` the
    batch rows.  The same for every layer with that ``S``, so made once per
    step."""
    slot = (pos % S).long()
    kv_len = torch.clamp(pos + 1, max=S).to(torch.int32).expand(b).contiguous()
    rows = torch.arange(b, device=pos.device) if pos.ndim == 1 else None
    return slot, kv_len, rows


def _block_decode(bp, x, cl, cfg: ModelConfig, ctx: RunCtx, rope, index):
    """One attention block for one token per slot; writes its K/V into
    ``cl`` in place.  ``rope``: (cos, sin) at the step's positions;
    ``index``: ``_step_index`` for this cache's length."""
    slot, kv_len, rows = index
    h = _norm(bp["norm1"], x, cfg)
    q, k, v = L.qkv_proj(bp["attn"], h, cfg)
    cos, sin = rope
    q = L.apply_rotary(q, cos, sin)
    k = L.apply_rotary(k, cos, sin)
    if rows is not None:
        cl["k"][rows, slot] = k[:, 0].to(cl["k"].dtype)
        cl["v"][rows, slot] = v[:, 0].to(cl["v"].dtype)
    else:
        cl["k"].index_copy_(1, slot.reshape(1), k.to(cl["k"].dtype))
        cl["v"].index_copy_(1, slot.reshape(1), v.to(cl["v"].dtype))
    o = decode_attention(q, cl["k"], cl["v"], kv_len,
                         backend=ctx.decode_backend)
    x = x + L.out_proj(bp["attn"], o)
    return x + L.mlp(bp["mlp"], _norm(bp["norm2"], x, cfg))


def _layers(params, cache, cfg: ModelConfig, pattern):
    """(block params, layer cache, effective kind, window) in stack order."""
    u, reps, rem = stack_plan(layer_sigs(cfg))
    for r in range(reps):
        bps, cls = take(params["unit"], r), take(cache["unit"], r)
        for j in range(u):
            yield (bps[f"p{j}"], cls[f"p{j}"]) + _effective(cfg, pattern, j)
    for i in range(rem):
        li = u * reps + i
        yield ((params["rest"][f"l{li}"], cache["rest"][f"l{li}"])
               + _effective(cfg, pattern, li))


def _head(params, x, cfg: ModelConfig):
    x = _norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head).float()


def decode_step(params, cache, tokens, cfg: ModelConfig, ctx: RunCtx,
                pattern: Optional[Sequence[str]] = None):
    """One decode step. tokens (b, 1) int -> (logits (b, V) f32, cache).

    ``cache["pos"]`` scalar: lockstep batch (all rows the same age).
    ``cache["pos"]`` (b,): per-slot lengths, one step for a mixed-age batch.
    """
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    pos = cache["pos"]
    x = params["embed"][tokens].to(ctx.compute_dtype)
    rope = L.rope_angles(pos[:, None] if pos.ndim == 1 else pos[None],
                         cfg.resolved_head_dim, cfg.rope_theta)
    index = {}
    for bp, cl, _, _ in _layers(params, cache, cfg, pattern):
        S = cl["k"].shape[1]
        if S not in index:
            index[S] = _step_index(pos, S, tokens.shape[0])
        x = _block_decode(bp, x, cl, cfg, ctx, rope, index[S])
    logits = _head(params, x[:, 0], cfg)
    cache["pos"] = pos + 1
    return logits, cache


# ---------------------------------------------------------------------------
# fused prefill


_PREFILL_MASK = {ATTN_FULL: "causal", ATTN_SWA: "swa", ATTN_LOCAL: "swa"}


def _block_prefill(bp, x, cl, cfg: ModelConfig, ctx: RunCtx, kind: str,
                   window: int, rope):
    """One block over the whole prompt (b, s, d), filling ``cl`` in place."""
    s = x.shape[1]
    h = _norm(bp["norm1"], x, cfg)
    q, k, v = L.qkv_proj(bp["attn"], h, cfg)
    cos, sin = rope
    q = L.apply_rotary(q, cos, sin)
    k = L.apply_rotary(k, cos, sin)
    S = cl["k"].shape[1]
    if s <= S:
        cl["k"][:, :s] = k
        cl["v"][:, :s] = v
    else:
        # ring smaller than the prompt: the surviving entry at slot j is the
        # last position = j (mod S), all within the final S tokens
        idx = torch.arange(s - S, s, device=x.device) % S
        cl["k"][:, idx] = k[:, s - S:].to(cl["k"].dtype)
        cl["v"][:, idx] = v[:, s - S:].to(cl["v"].dtype)
    # attention over the in-flight full-length K/V (exact; the ring only
    # constrains what later decode steps can still see); the mask follows
    # the *effective* kind: a long-context variant runs full layers as SWA
    o = chunked_attention(q, k, v, kind=_PREFILL_MASK[kind], window=window,
                          backend=ctx.prefill_backend)
    x = x + L.out_proj(bp["attn"], o)
    return x + L.mlp(bp["mlp"], _norm(bp["norm2"], x, cfg))


def prefill_cache(params, tokens, cache, cfg: ModelConfig, ctx: RunCtx,
                  pattern: Optional[Sequence[str]] = None):
    """Fused prefill: one forward pass over the prompt fills the cache.

    tokens (b, s) against a *fresh* cache (``pos`` all zero).  Returns
    (last-position logits (b, V) f32, the cache with ``pos`` advanced by s).
    """
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    s = tokens.shape[1]
    x = params["embed"][tokens].to(ctx.compute_dtype)
    rope = L.rope_angles(torch.arange(s, device=x.device),
                         cfg.resolved_head_dim, cfg.rope_theta)
    for bp, cl, kind, window in _layers(params, cache, cfg, pattern):
        x = _block_prefill(bp, x, cl, cfg, ctx, kind, window, rope)
    logits = _head(params, x[:, -1], cfg)
    cache["pos"] = cache["pos"] + s
    return logits, cache

"""Serving: KV caches (fixed-slot and paged), slot ops, fused and chunked
prefill, decode step.

Counterpart of ``repro/models/decode.py``, for every family the port
serves.

Cache kinds per layer, sized from the *effective* pattern:

* full attention — (b, S, kv, hd) K/V, slot = pos
* SWA / local    — ring buffer (b, W, kv, hd), slot = pos % W; RoPE is
  applied at write time, so the ring's storage order is harmless
* RG-LRU         — ``h`` (b, r) f32 and ``conv`` (b, 3, r) taps
* mLSTM          — ``c`` (b, nh, hd, hd), ``n`` (b, nh, hd), ``m`` (b, nh)
* sLSTM          — ``c``, ``n``, ``h``, ``m`` (b, nh, hd)
* whisper's decoder blocks add ``ck``/``cv`` (b, encoder_seq_len, kv, hd):
  the cross-attention K/V over the encoder's output, filled by
  :func:`prefill_cross_kv`

The recurrent and xLSTM states (all f32) are O(1) in the sequence length;
they and ``ck``/``cv`` stay slot-resident in the paged layout too.

The cache is the reference's dict: ``unit`` (each leaf stacked over the
unit's repeats), ``rest`` and ``pos`` — a scalar for an offline batch that
advances in lockstep, a (b,) vector of per-slot lengths for continuous
batching.  Two continuous-batching layouts share the decode step:

* **fixed-slot** (``init_slot_cache``/``slot_insert``/``slot_evict``) —
  every slot owns a dense (S, kv, hd) row per layer;
* **paged** (``init_paged_cache``/``paged_insert``/``paged_evict``, reached
  through the same ``slot_insert``/``slot_evict``) — K/V live in per-layer
  pools (num_pages + max_batch, pg, kv, hd) behind a (max_batch, ncols)
  int32 block table ``bt``; a host-side :class:`~repro_torch.models.paging.
  PagePool` hands out the pages.  The last ``max_batch`` rows are per-slot
  scratch pages that absorb the writes of freed slots riding the batch.
  Decode resolves the table inside ``flash_decode_paged``; its plain version
  gathers the pages into the fixed layout's view, so the two layouts decode
  bit-identical logits at identical occupancy.

:class:`ChunkedPrefill` splits the fused prefill into chunks a scheduler can
interleave with decode steps, and can start past a prompt prefix whose K/V
it takes from shared pages (``gather_prefix_kv``).

Unlike the reference, which is functional, these functions write the K/V
caches and recurrent states in place (a decode step touches one row per
slot, and copying the whole cache per step would double its memory
traffic) and return the same dict with ``pos`` advanced.  Two rules keep the paged layout sound in place:
``paged_evict`` retargets the table and never touches a pool page (after
the host frees it, a page may already hold another request), and a decode
write lands at ``pos >= prompt_len``, never on a shared prefix page.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import is_dtensor, resolve_device
from repro_torch.configs.base import (ATTN_FULL, MLSTM, RECURRENT, SLSTM,
                                      ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import (chunked_attention, decode_attention,
                                          paged_decode_attention)
from repro_torch.models.transformer import (_MASK, ATTN_KINDS, RunCtx,
                                            _effective,
                                            _head_sharded_attention,
                                            _lm_head, _norm,
                                            check_supported, cross_query,
                                            embed, encode, ffn_fwd,
                                            layer_sigs, proj_cross, rope_for,
                                            rotate, stack_plan, take)
from repro_torch.obs import spans

# the fused prefill's mLSTM chunk (the reference's prefill_cache)
FUSED_MLSTM_CHUNK = 256


def _attn_cache_shape(cfg: ModelConfig, batch: int, cache_len: int,
                      kind: str, window: int):
    S = cache_len if kind == ATTN_FULL else min(window, cache_len)
    return (batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)


def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int, kind: str,
                     window: int, dtype, device, reps: int = 0,
                     cross: bool = False):
    """Zero state for one layer (``reps`` > 0: stacked over them): K/V for
    an attention layer, the f32 states of an RG-LRU (``conv`` in ``dtype``),
    mLSTM or sLSTM layer; ``cross`` adds the (zero) cross K/V ``ck``/``cv``.
    The stabilisers ``m`` start at zero, as the reference's caches do."""
    lead = (reps,) if reps else ()
    f32 = dict(dtype=torch.float32, device=device)
    if kind == RECURRENT:
        h, conv = rglru_lib.state_shapes(cfg, batch)
        c = {"h": torch.zeros(lead + h, **f32),
             "conv": torch.zeros(lead + conv, dtype=dtype, device=device)}
    elif kind == MLSTM:
        c = {name: torch.zeros(lead + sh, **f32) for name, sh in zip(
            ("c", "n", "m"), xlstm_lib.mlstm_state_shapes(cfg, batch))}
    elif kind == SLSTM:
        sh = lead + xlstm_lib.slstm_state_shape(cfg, batch)
        c = {name: torch.zeros(sh, **f32) for name in ("c", "n", "h", "m")}
    else:
        sh = lead + _attn_cache_shape(cfg, batch, cache_len, kind, window)
        c = {"k": torch.zeros(sh, dtype=dtype, device=device),
             "v": torch.zeros(sh, dtype=dtype, device=device)}
    if cross:
        c.update(_cross_cache(cfg, batch, dtype, device, lead))
    return c


def _cross_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    """Zero ``ck``/``cv`` (lead + (b, encoder_seq_len, kv, hd))."""
    sh = lead + (batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
    return {leaf: torch.zeros(sh, dtype=dtype, device=device)
            for leaf in ("ck", "cv")}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: RunCtx,
               pattern: Optional[Sequence[str]] = None, as_spec: bool = False):
    """Full decode cache dict, mirroring the stack plan layout.  ``as_spec``
    gives the same tree on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ``ShapeDtypeStruct`` tree)."""
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    check_supported(cfg, pattern)
    dev = torch.device("meta") if as_spec else resolve_device(ctx.device)
    u, reps, rem = stack_plan(layer_sigs(cfg))
    cross = cfg.encoder_layers > 0
    cache: Dict[str, Any] = {"unit": {}, "rest": {}}
    for j in range(u):
        kind, window = _effective(cfg, pattern, j)
        cache["unit"][f"p{j}"] = init_layer_cache(
            cfg, batch, cache_len, kind, window, ctx.param_dtype, dev, reps,
            cross)
    for i in range(rem):
        li = u * reps + i
        kind, window = _effective(cfg, pattern, li)
        cache["rest"][f"l{li}"] = init_layer_cache(
            cfg, batch, cache_len, kind, window, ctx.param_dtype, dev,
            cross=cross)
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


def slot_insert(cache, slot: int, src, src_slot: int = 0, pages=None,
                skip_cols: int = 0):
    """Copy one request's state out of ``src`` into ``cache`` slot ``slot``.

    ``src`` is a cache of the same config and cache_len, typically the
    batch-1 output of ``prefill_cache``.  Every per-slot leaf is
    overwritten, so the slot's previous occupant needs no cleanup.  A paged
    ``cache`` goes to :func:`paged_insert`, which needs the slot's ``pages``.
    """
    if _is_paged(cache):
        if pages is None:
            raise ValueError("paged cache: slot_insert needs `pages`")
        return paged_insert(cache, slot, src, pages, src_slot,
                            skip_cols=skip_cols)
    for part, name, dst, stacked in _layers_of(cache):
        _copy_slot(dst, src[part][name], slot, src_slot, stacked)
    cache["pos"][slot] = src["pos"].reshape(-1)[src_slot]
    return cache


def slot_evict(cache, slot: int):
    """Release ``slot``: zero its state and reset its length.

    A freed slot keeps riding the batched step (its logits are ignored): at
    ``pos`` 0 it reads one zeroed entry, masked by its kv_len of 1, and a
    zeroed recurrent state stays finite.  A paged cache goes to
    :func:`paged_evict`.
    """
    if _is_paged(cache):
        return paged_evict(cache, slot)
    for _, _, dst, stacked in _layers_of(cache):
        _zero_slot(dst, slot, stacked)
    cache["pos"][slot] = 0
    return cache


def _layers_of(cache):
    """(part, layer name, layer dict, stacked over repeats?) for every
    layer of a cache."""
    for part, stacked in (("unit", True), ("rest", False)):
        for name, cl in cache[part].items():
            yield part, name, cl, stacked


def _copy_slot(dst, src, slot: int, src_slot: int, stacked: bool):
    """Every leaf of layer ``dst`` at ``slot`` from ``src`` at ``src_slot``
    (a stacked layer has the slot on axis 1)."""
    for leaf, t in dst.items():
        if stacked:
            t[:, slot] = src[leaf][:, src_slot]
        else:
            t[slot] = src[leaf][src_slot]


def _resident(cl):
    """The slot-resident leaves of a layer: all but a paged layer's pools
    and block table."""
    return {k: t for k, t in cl.items() if k not in ("k", "v", "bt")
            or "bt" not in cl}


def _zero_slot(dst, slot: int, stacked: bool):
    for t in dst.values():
        if stacked:
            t[:, slot] = 0
        else:
            t[slot] = 0


# ---------------------------------------------------------------------------
# paged KV cache


def _is_paged(cache) -> bool:
    """A paged cache carries a block table ("bt") in its attention layers."""
    for part in ("unit", "rest"):
        for cl in cache.get(part, {}).values():
            if "bt" in cl:
                return True
            if "k" in cl:           # attention layer without a table: fixed
                return False
    return False


def _layer_page_geometry(S: int, page_size: int) -> Tuple[int, int]:
    """(page tokens, columns) for a layer of logical length ``S``: the
    requested page size where it divides ``S``, else their gcd, so a ring
    shorter than a page or an odd window still tiles exactly."""
    pg = page_size if S % page_size == 0 else math.gcd(S, page_size)
    return pg, S // pg


def _attn_layer_lens(cfg: ModelConfig, cache_len: int,
                     pattern: Optional[Sequence[str]] = None) -> List[int]:
    """Logical cache length of every attention layer (full: S, SWA: ring W)."""
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    lens = []
    for li in range(cfg.num_layers):
        kind, window = _effective(cfg, pattern, li)
        if kind in ATTN_KINDS:
            lens.append(_attn_cache_shape(cfg, 1, cache_len, kind, window)[1])
    return lens


def pages_needed(cfg: ModelConfig, cache_len: int, page_size: int,
                 n_tokens: int,
                 pattern: Optional[Sequence[str]] = None) -> int:
    """Pages a request holding ``n_tokens`` (prompt + all generated) needs:
    the slot's page list is shared across layers (each reads its own prefix
    of it against its own pool), so the most columns any layer needs."""
    need = 0
    for S in _attn_layer_lens(cfg, cache_len, pattern):
        pg, _ = _layer_page_geometry(S, page_size)
        need = max(need, -(-min(n_tokens, S) // pg))
    return need


def prefix_sharing_supported(cfg: ModelConfig, cache_len: int, page_size: int,
                             pattern: Optional[Sequence[str]] = None
                             ) -> Optional[int]:
    """Page token count if this config can share prompt-prefix pages, else
    None.

    A page is shareable only when its content is a pure function of the
    prompt prefix and its donor never rewrites it: full-attention prompt
    pages qualify (post-RoPE K/V at absolute positions; decode writes land
    at ``pos >= prompt_len``), SWA/local rings do not (they rewrap into
    their pages during decode).  So every effective layer must be ATTN_FULL
    and the stack encoder-free, which also makes the page geometry uniform.
    """
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    if cfg.encoder_layers > 0:
        return None
    for li in range(cfg.num_layers):
        kind, _ = _effective(cfg, pattern, li)
        if kind != ATTN_FULL:
            return None
    pg, _ = _layer_page_geometry(cache_len, page_size)
    return pg


def init_paged_cache(cfg: ModelConfig, max_batch: int, cache_len: int,
                     ctx: RunCtx, *, page_size: int, num_pages: int,
                     pattern: Optional[Sequence[str]] = None):
    """Paged continuous-batching cache: block-table indirection per slot.

    Each attention layer holds ``k``/``v`` pools (num_pages + max_batch, pg,
    kv, hd) (stacked over the unit's repeats) and ``bt`` (max_batch, ncols)
    int32 mapping its logical pages to pool rows, every entry at first the
    slot's own scratch row ``num_pages + slot``; recurrent and xLSTM states
    and whisper's cross K/V stay slot-resident, as in
    :func:`init_slot_cache`; ``pos`` is a
    (max_batch,) int32 vector.  Claim slots with :func:`paged_insert`
    (pages from a :class:`~repro_torch.models.paging.PagePool`), release
    them with :func:`paged_evict`.
    """
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    check_supported(cfg, pattern)
    dev = resolve_device(ctx.device)
    scratch = torch.arange(num_pages, num_pages + max_batch,
                           dtype=torch.int32, device=dev)

    cross = cfg.encoder_layers > 0

    def layer(kind, window, reps=0):
        if kind not in ATTN_KINDS:
            return init_layer_cache(cfg, max_batch, cache_len, kind, window,
                                    ctx.param_dtype, dev, reps, cross)
        lead = (reps,) if reps else ()
        cl = (_cross_cache(cfg, max_batch, ctx.param_dtype, dev, lead)
              if cross else {})
        _, S, kv, hd = _attn_cache_shape(cfg, 1, cache_len, kind, window)
        pg, ncols = _layer_page_geometry(S, page_size)
        pool = (num_pages + max_batch, pg, kv, hd)
        bt = scratch[:, None].expand(max_batch, ncols)
        if reps:
            pool = (reps,) + pool
            bt = bt.expand(reps, max_batch, ncols)
        cl.update(k=torch.zeros(pool, dtype=ctx.param_dtype, device=dev),
                  v=torch.zeros(pool, dtype=ctx.param_dtype, device=dev),
                  bt=bt.contiguous())
        return cl

    u, reps, rem = stack_plan(layer_sigs(cfg))
    cache: Dict[str, Any] = {"unit": {}, "rest": {}}
    for j in range(u):
        cache["unit"][f"p{j}"] = layer(*_effective(cfg, pattern, j), reps)
    for i in range(rem):
        li = u * reps + i
        cache["rest"][f"l{li}"] = layer(*_effective(cfg, pattern, li))
    cache["pos"] = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
    return cache


def paged_insert(cache, slot: int, src, pages: Sequence[int],
                 src_slot: int = 0, skip_cols: int = 0):
    """Copy one request out of a fixed-layout ``src`` of the same cache_len
    (the batch-1 output of ``prefill_cache`` / ``ChunkedPrefill.finish``)
    into the paged ``cache``.

    ``pages`` (host ints from a ``PagePool``) must cover every page the
    request will touch, ``pages_needed(cfg, cache_len, page_size,
    prompt_len + max_new_tokens)``: decode writes ride the block table.
    Each layer takes its own prefix of the list; its other columns point at
    the slot's scratch row.  The first ``skip_cols`` pages are *shared*
    prefix pages, already holding exactly this request's content: the
    table maps them and nothing writes them.  Only the columns that map to
    the request's own pages are written, so no two writes hit one row (the
    unassigned columns all map to the one scratch row, and lie past every
    position the request reaches, masked by its kv_len).  Slot-resident
    leaves (recurrent and xLSTM states, cross K/V) are copied as
    :func:`slot_insert` copies them.
    """
    max_batch = cache["pos"].shape[0]
    pages = [int(p) for p in pages]
    dev = cache["pos"].device
    for part, name, dst, stacked in _layers_of(cache):
        _copy_slot(_resident(dst), src[part][name], slot, src_slot, stacked)
        if "bt" not in dst:
            continue
        bt = dst["bt"]
        ncols = bt.shape[-1]
        rows_total, pg = dst["k"].shape[-4], dst["k"].shape[-3]
        own = pages[:ncols]
        row = own + [rows_total - max_batch + slot] * (ncols - len(own))
        cols = list(range(min(int(skip_cols), len(own)), len(own)))
        if cols:
            dst_rows = torch.tensor([own[c] for c in cols], device=dev)
            src_cols = torch.tensor(cols, device=dev)
            for leaf in ("k", "v"):
                sl = src[part][name][leaf]
                sl = sl[:, src_slot] if stacked else sl[src_slot]
                chunks = sl.reshape(sl.shape[:-3] + (ncols, pg)
                                    + sl.shape[-2:]).to(dst[leaf].dtype)
                if stacked:
                    dst[leaf][:, dst_rows] = chunks[:, src_cols]
                else:
                    dst[leaf][dst_rows] = chunks[src_cols]
        row_t = torch.tensor(row, dtype=torch.int32, device=dev)
        if stacked:
            bt[:, slot] = row_t
        else:
            bt[slot] = row_t
    cache["pos"][slot] = src["pos"].reshape(-1)[src_slot]
    return cache


def paged_evict(cache, slot: int):
    """Release ``slot``: point its table row back at the slot's scratch row,
    zero its slot-resident leaves and reset its length.  Pool pages
    are never touched: once the host has freed them they may belong to
    another request.  Their old content needs no cleanup (reads are
    kv_len-masked, ``paged_insert`` writes every page it hands a new
    request)."""
    max_batch = cache["pos"].shape[0]
    for _, _, dst, stacked in _layers_of(cache):
        _zero_slot(_resident(dst), slot, stacked)
        if "bt" not in dst:
            continue
        scr = dst["k"].shape[-4] - max_batch + slot
        if stacked:
            dst["bt"][:, slot] = scr
        else:
            dst["bt"][slot] = scr
    cache["pos"][slot] = 0
    return cache


def gather_prefix_kv(cache, pages: Sequence[int], n_tokens: int):
    """The first ``n_tokens`` of K/V held in ``pages`` of a paged cache.

    Returns one ``{"k", "v"}`` dict of (1, n_tokens, kv, hd) tensors per
    layer, in ``ChunkedPrefill``'s carry order (unit layer ``r * u + j``,
    then the rest): the carry a prefill of those tokens would have built.
    The tensors are copies (advanced indexing), so they stay valid once the
    donor's pages are recycled; the copy of a partial tail page is the
    copy-on-write copy.  Valid under :func:`prefix_sharing_supported`.
    """
    rows = torch.tensor([int(p) for p in pages], dtype=torch.long,
                        device=cache["pos"].device)

    def gather(cl):
        pg, kv, hd = cl["k"].shape[-3:]
        return {leaf: cl[leaf][rows].reshape(1, len(pages) * pg, kv,
                                             hd)[:, :n_tokens]
                for leaf in ("k", "v")}

    u = len(cache["unit"])
    reps = next(iter(cache["unit"].values()))["k"].shape[0] if u else 0
    out = [gather(take(cache["unit"], r)[f"p{j}"])
           for r in range(reps) for j in range(u)]
    for key in sorted(cache["rest"], key=lambda name: int(name[1:])):
        out.append(gather(cache["rest"][key]))
    return out


# ---------------------------------------------------------------------------
# whisper's cross K/V


def prefill_cross_kv(params, audio_feats, cfg: ModelConfig, ctx: RunCtx,
                     cache):
    """Run whisper's encoder over ``audio_feats`` (b, encoder_seq_len,
    d_model) and write every decoder block's cross K/V (its own ``wk``/
    ``wv`` of the encoder's output) into the cache's ``ck``/``cv``, in
    place; returns the cache.  The encoder attends on
    ``ctx.prefill_backend`` (``flash_attention`` on the card, bidir), without
    autograd: this is the serving path."""
    with torch.no_grad():
        enc_out = encode(params, audio_feats, cfg, ctx,
                         backend=ctx.prefill_backend)
        for part, name, cl, stacked in _layers_of(cache):
            bp = params[part][name]
            for r in range(cl["ck"].shape[0] if stacked else 1):
                ck, cv = proj_cross(take(bp, r) if stacked else bp, enc_out,
                                    cfg)
                (cl["ck"][r] if stacked else cl["ck"]).copy_(ck)
                (cl["cv"][r] if stacked else cl["cv"]).copy_(cv)
    return cache


# ---------------------------------------------------------------------------
# decode


def _layer_len(cl):
    """(logical length S, page tokens or 0) of an attention layer's cache."""
    if "bt" in cl:
        pg = cl["k"].shape[1]
        return cl["bt"].shape[1] * pg, pg
    return cl["k"].shape[1], 0


def _step_index(pos, S: int, pg: int, b: int):
    """Where one decode step writes and reads a cache of length ``S``: the
    write slot ``pos % S`` (full cache: pos < S so slot == pos; ring: wraps),
    the (b,) int32 ``kv_len = min(pos + 1, S)``, and for per-slot ``pos`` the
    batch rows; for a paged layer (``pg`` > 0) the slot's block-table column
    and the offset in its page instead of the slot.  The same for every
    layer of that geometry, so made once per step."""
    slot = (pos % S).long()
    kv_len = torch.clamp(pos + 1, max=S).to(torch.int32).expand(b).contiguous()
    rows = torch.arange(b, device=pos.device) if pos.ndim == 1 else None
    if pg:
        if rows is None:
            raise ValueError("a paged cache needs per-slot pos")
        slot = (slot // pg, slot % pg)
    return slot, kv_len, rows


def _block_decode(bp, x, cl, cfg: ModelConfig, ctx: RunCtx, sig, rope,
                  index, cross_len):
    """One block for one token per slot; writes the layer's new state into
    ``cl`` in place.  ``rope``: (cos, sin) at the step's positions (None,
    None without RoPE); ``index``: ``_step_index`` for an attention cache's
    geometry (None for a recurrent or xLSTM layer); ``cross_len``: the
    (b,) int32 kv_len of the cross K/V (every encoder frame)."""
    kind, ffn = sig
    h = _norm(bp["norm1"], x, cfg)
    if kind == RECURRENT:
        y, hh, conv = rglru_lib.rglru_decode_step(bp["rglru"], h, cl["h"],
                                                  cl["conv"])
        _store(cl, h=hh, conv=conv)
    elif kind == MLSTM:
        y, st = xlstm_lib.mlstm_decode_step(
            bp["mlstm"], h, cfg, xlstm_lib.MLSTMState(cl["c"], cl["n"],
                                                      cl["m"]))
        _store(cl, **st._asdict())
    elif kind == SLSTM:
        y, st = xlstm_lib.slstm_decode_step(
            bp["slstm"], h, cfg, xlstm_lib.SLSTMState(cl["c"], cl["n"],
                                                      cl["h"], cl["m"]))
        _store(cl, **st._asdict())
    else:
        y = _attention_decode(bp["attn"], h, cl, cfg, ctx, rope, index)
    # on a mesh the residual keeps its batch over the data axes, here and
    # after the block: left to DTensor, the products drift to layouts that
    # replicate them (qwen2-0.5b decode_32k on 16 x 16: 2.8x the flops)
    x = ctx.act(x + y)
    if "ck" in cl:
        hc = _norm(bp["norm_cross"], x, cfg)
        o = decode_attention(cross_query(bp["cross"], hc, cfg), cl["ck"],
                             cl["cv"], cross_len, backend=ctx.decode_backend,
                             seq_axis=ctx.tp_axis)
        x = x + L.out_proj(bp["cross"], o)
    return ffn_fwd(bp, x, cfg, ffn, ctx)[0]


def _store(cl, **state):
    """Write a layer's new recurrent state into its cache, in place."""
    for leaf, t in state.items():
        cl[leaf].copy_(t)


def _write_step(buf, slot, x) -> None:
    """``buf[:, slot] = x[:, 0]`` in place, along the sequence dim of a
    (b, S, ...) cache.

    A ``DTensor`` cache (a mesh, ``dist/sharding.py::cache_specs``: the
    sequence over ``tp``) is written on its local shards: ``x`` is brought
    to the cache's placements with the sequence whole, and each rank writes
    at ``slot`` less its shard's offset, clamped into its shard, the new
    row where it holds ``slot`` and its own row back elsewhere, so no data
    moves between ranks.  DTensor itself has no rule for ``index_copy_`` on
    a sharded dim in every torch version."""
    if not is_dtensor(buf):
        buf.index_copy_(1, slot.reshape(1), x)
        return
    x = _seq_whole(x, buf)
    if is_dtensor(slot):
        slot = slot.to_local()
    local = buf.to_local()
    # this rank's first sequence position
    at = (slot.reshape(1)
          - L.shard_index(buf.device_mesh, buf.placements, 1)
          * local.shape[1])
    held = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, local.shape[1] - 1)
    local.index_copy_(1, at, torch.where(held, x, local.index_select(1, at)))


def _seq_whole(x, buf):
    """The local rows of ``x`` (b, s, ...) as the ``DTensor`` cache ``buf``
    places its batch, with the sequence whole on every rank."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(buf.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in buf.placements
    ]).to_local()


def _attention_decode(p, h, cl, cfg: ModelConfig, ctx: RunCtx, rope, index):
    """Attention of one token per slot over the layer's cache, after
    writing the token's K/V into it."""
    slot, kv_len, rows = index
    q, k, v = L.qkv_proj(p, h, cfg)
    q, k = rotate(q, k, rope)
    if "bt" in cl:
        # paged: this token goes to offset r % pg of pool row bt[slot, r // pg]
        # (a freed slot writes to its own scratch row); attention then reads
        # the slot's pages through the table
        col, off = slot
        page = cl["bt"][rows, col].long()
        cl["k"][page, off] = k[:, 0].to(cl["k"].dtype)
        cl["v"][page, off] = v[:, 0].to(cl["v"].dtype)
        o = paged_decode_attention(q, cl["k"], cl["v"], cl["bt"], kv_len,
                                   backend=ctx.decode_backend)
        return L.out_proj(p, o)
    if rows is not None:
        cl["k"][rows, slot] = k[:, 0].to(cl["k"].dtype)
        cl["v"][rows, slot] = v[:, 0].to(cl["v"].dtype)
    else:
        _write_step(cl["k"], slot, k.to(cl["k"].dtype))
        _write_step(cl["v"], slot, v.to(cl["v"].dtype))
    o = decode_attention(q, cl["k"], cl["v"], kv_len,
                         backend=ctx.decode_backend, seq_axis=ctx.tp_axis)
    return L.out_proj(p, o)


def _layers(params, cache, cfg: ModelConfig, pattern):
    """(block params, layer cache, signature, effective kind, window) in
    stack order."""
    sigs = layer_sigs(cfg)
    u, reps, rem = stack_plan(sigs)
    for r in range(reps):
        bps, cls = take(params["unit"], r), take(cache["unit"], r)
        for j in range(u):
            yield ((bps[f"p{j}"], cls[f"p{j}"], sigs[j])
                   + _effective(cfg, pattern, j))
    for i in range(rem):
        li = u * reps + i
        yield ((params["rest"][f"l{li}"], cache["rest"][f"l{li}"], sigs[li])
               + _effective(cfg, pattern, li))


def _head(params, x, cfg: ModelConfig):
    x = _norm(params["final_norm"], x, cfg)
    return torch.matmul(x, _lm_head(params, cfg)).float()


def decode_step(params, cache, tokens, cfg: ModelConfig, ctx: RunCtx,
                pattern: Optional[Sequence[str]] = None):
    """One decode step. tokens (b, 1) int -> (logits (b, V) f32, cache).

    ``cache["pos"]`` scalar: lockstep batch (all rows the same age).
    ``cache["pos"]`` (b,): per-slot lengths, one step for a mixed-age batch.
    Positions enter as RoPE, or as whisper's sinusoidal embedding (qwen2-vl
    serves on 1-D RoPE, as the reference's decode does).

    On a mesh (params and cache ``DTensor``s placed by ``dist/sharding.py``)
    attention decodes on each rank's local shards and merges the sequence's
    chunks by their log-sum-exp (``models/attention.py::decode_attention``).
    """
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    # on a mesh the step's host-made tensors join the DTensors replicated
    with L.on_mesh(params["embed"]):
        pos = cache["pos"]
        b = tokens.shape[0]
        at = pos[:, None] if pos.ndim == 1 else pos[None]     # (b, 1) | (1,)
        # on a mesh: the batch over the data axes where it divides them, else
        # replicated (the embedding's vocab-partial sum reduced once, here)
        x = ctx.act(embed(params, tokens, cfg, ctx, positions=at))
        rope = rope_for(cfg, at)
        cross_len = (torch.full((b,), cfg.encoder_seq_len, dtype=torch.int32,
                                device=pos.device)
                     if cfg.encoder_layers else None)
        index = {None: None}
        for bp, cl, sig, _, _ in _layers(params, cache, cfg, pattern):
            geom = _layer_len(cl) if sig[0] in ATTN_KINDS else None
            if geom not in index:
                index[geom] = _step_index(pos, *geom, b)
            x = ctx.act(_block_decode(bp, x, cl, cfg, ctx, sig, rope,
                                      index[geom], cross_len))
        logits = _head(params, x[:, 0], cfg)
        cache["pos"] = pos + 1
        return logits, cache


# ---------------------------------------------------------------------------
# prefill: chunked, and fused (one chunk)


class ChunkedPrefill:
    """Interleavable prefill: the prompt advances in scheduler-sized chunks.

    Construct with a *fresh* cache (``pos`` all zero; whisper's cross K/V
    already filled by :func:`prefill_cross_kv`, or left zero, as the slot
    runner leaves it); once every chunk has been issued, ``finish()``
    returns ``(last-position logits (b, V) f32, the cache with pos
    advanced)``.  The work happens over repeated ``step(n_tokens)`` calls,
    so a scheduler can slip decode steps between chunks;
    :func:`prefill_cache` is the one-chunk case.  Chunk ``[lo, hi)`` embeds
    at absolute positions (RoPE, or whisper's sinusoidal positions, from
    ``lo``), appends its K/V to each attention layer's contiguous carry and
    attends against the whole prefix with ``chunked_attention(q_offset=lo,
    backend=ctx.prefill_backend)`` (``flash_attention`` on the card).  SWA
    layers keep the carry contiguous too (attention over the in-flight K/V
    is exact; the ring only constrains what later decode steps can see).
    RG-LRU, mLSTM and sLSTM layers carry their states from chunk to chunk;
    an mLSTM layer runs each step as chunks of ``mlstm_chunk`` (None: the
    step's own length, as the reference's ``ChunkedPrefill``; either way
    the step's length where the chunk does not divide it).  Whisper's
    blocks attend the cross K/V bidirectionally after their self-attention.
    The last chunk writes each layer's state into the cache as it goes,
    folding SWA layers into their ring, so the one-chunk case does the
    fused prefill's work in its order.  A MoE layer routes each chunk in
    groups of ``min(group_size, chunk)`` tokens, as the reference's does, so
    chunking changes its output only where a group's capacity drops
    tokens.

    Prefix sharing: ``start_token``/``prefix_kv`` seed the carry with the
    first ``start_token`` tokens' K/V (from :func:`gather_prefix_kv`), so
    ``step`` begins at the first uncached token.  Callers keep
    ``start_token < total``: the last prompt token is prefilled live to
    produce the logits that seed sampling.
    """

    def __init__(self, params, tokens, cache, cfg: ModelConfig, ctx: RunCtx,
                 pattern: Optional[Sequence[str]] = None,
                 start_token: int = 0,
                 prefix_kv: Optional[List[Any]] = None,
                 mlstm_chunk: Optional[int] = None):
        pattern = tuple(pattern) if pattern is not None else cfg.pattern
        check_supported(cfg, pattern)
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self.tokens = tokens
        self.total = int(tokens.shape[1])
        self.start_token = int(start_token)
        if not 0 <= self.start_token < max(self.total, 1):
            raise ValueError(
                f"start_token {start_token} outside [0, {self.total})")
        self.done_tokens = self.start_token
        self.mlstm_chunk = mlstm_chunk
        self._cache = cache
        self._layers = list(_layers(params, cache, cfg, pattern))
        self._carry: List[Optional[Dict[str, Any]]] = [None] * len(
            self._layers)
        if self.start_token:
            if prefix_kv is None or len(prefix_kv) != len(self._layers):
                raise ValueError("start_token > 0 needs per-layer prefix_kv")
            self._carry = [{leaf: st[leaf].to(ctx.compute_dtype)
                            for leaf in ("k", "v")} for st in prefix_kv]
        self._logits = None

    @property
    def done(self) -> bool:
        return self.done_tokens >= self.total

    @property
    def remaining(self) -> int:
        return self.total - self.done_tokens

    def step(self, n_tokens: int) -> int:
        """Advance prefill by up to ``n_tokens``; returns tokens processed
        (a chunk run is the span ``repro.serve.prefill_chunk``)."""
        with spans.span("repro.serve.prefill_chunk"):
            return self._run_chunk(n_tokens)

    def _run_chunk(self, n_tokens: int) -> int:
        cfg, ctx = self.cfg, self.ctx
        lo = self.done_tokens
        hi = min(lo + int(n_tokens), self.total)
        if hi <= lo:
            return 0
        at = torch.arange(lo, hi, device=self.tokens.device)
        last = hi == self.total
        # on a mesh the chunk's host-made tensors join the DTensors
        # replicated
        with L.on_mesh(self.params["embed"]):
            x = ctx.act(embed(self.params, self.tokens[:, lo:hi], cfg, ctx,
                              positions=at))
            rope = rope_for(cfg, at)
            for li, (bp, cl, sig, kind, window) in enumerate(self._layers):
                x = self._block(bp, x, li, cl, sig, kind, window, rope, lo,
                                last)
            self._logits = _head(self.params, x[:, -1], cfg)
        self.done_tokens = hi
        return hi - lo

    def _block(self, bp, x, li, cl, sig, kind, window, rope, lo, last):
        """One block over chunk ``[lo, hi)``; the last chunk writes the
        layer's state into ``cl`` in place and drops its carry."""
        cfg = self.cfg
        h = _norm(bp["norm1"], x, cfg)
        if sig[0] in ATTN_KINDS:
            x = x + self._attention(bp["attn"], h, li, cl, kind, window,
                                    rope, lo, last)
        else:
            x = x + self._recurrent(bp, sig[0], h, li, cl, last)
        if "ck" in cl:
            hc = _norm(bp["norm_cross"], x, cfg)
            q = cross_query(bp["cross"], hc, cfg)
            if is_dtensor(q):
                o = _head_sharded_attention(q, cl["ck"], cl["cv"], self.ctx,
                                            "bidir", 0, q.shape[1],
                                            self.ctx.prefill_backend)
            else:
                o = chunked_attention(q, cl["ck"], cl["cv"], kind="bidir",
                                      chunk_q=q.shape[1],
                                      chunk_k=self.ctx.chunk_k,
                                      backend=self.ctx.prefill_backend)
            x = x + L.out_proj(bp["cross"], o)
        return ffn_fwd(bp, x, cfg, sig[1])[0]

    def _recurrent(self, bp, kind, h, li, cl, last):
        """An RG-LRU, mLSTM or sLSTM layer from its carried state."""
        st = self._carry[li]
        if kind == RECURRENT:
            y, (hh, conv) = rglru_lib.rglru_block(
                bp["rglru"], h, h0=None if st is None else st["h"],
                conv0=None if st is None else st["conv"], return_state=True)
            new = {"h": hh, "conv": conv}
        elif kind == MLSTM:
            n = h.shape[1]
            chunk = min(self.mlstm_chunk or n, n)
            if n % chunk:
                chunk = n
            y, new = xlstm_lib.mlstm_chunked(bp["mlstm"], h, self.cfg,
                                             state=st, chunk=chunk,
                                             return_state=True)
        else:
            y, new = xlstm_lib.slstm_block(bp["slstm"], h, self.cfg,
                                           state=st, return_state=True)
        if last:
            self._carry[li] = None
            _store(cl, **(new if isinstance(new, dict) else new._asdict()))
        else:
            self._carry[li] = new
        return y

    def _attention(self, p, h, li, cl, kind, window, rope, lo, last):
        q, k, v = L.qkv_proj(p, h, self.cfg)
        q, k = rotate(q, k, rope)
        st = self._carry[li]
        if st is not None:
            k = torch.cat([st["k"], k], dim=1)
            v = torch.cat([st["v"], v], dim=1)
        if last:
            self._carry[li] = None
            _fill(cl, k, v)
        else:
            self._carry[li] = {"k": k, "v": v}
        if is_dtensor(q):
            o = _head_sharded_attention(q, k, v, self.ctx, _MASK[kind],
                                        window, self.ctx.chunk_q,
                                        self.ctx.prefill_backend,
                                        q_offset=lo)
        else:
            o = chunked_attention(q, k, v, kind=_MASK[kind], window=window,
                                  q_offset=lo, chunk_q=self.ctx.chunk_q,
                                  chunk_k=self.ctx.chunk_k,
                                  backend=self.ctx.prefill_backend)
        return L.out_proj(p, o)

    def finish(self):
        """(last-position logits, filled cache): ``prefill_cache``'s return
        for the same prompt, in the cache given at construction."""
        if not self.done:
            raise ValueError(
                f"prefill incomplete: {self.done_tokens}/{self.total} tokens")
        self._cache["pos"] = self._cache["pos"] + self.total
        return self._logits, self._cache


def _fill(cl, k, v):
    """Write a whole prompt's K/V (b, s, kv, hd) into a fresh layer cache."""
    s, S = k.shape[1], cl["k"].shape[1]
    for leaf, new in (("k", k), ("v", v)):
        if is_dtensor(cl[leaf]):
            _fill_shards(cl[leaf], new)
        elif s <= S:
            cl[leaf][:, :s] = new
        else:
            # ring smaller than the prompt: the survivor at slot j is the
            # last position = j (mod S)
            idx = torch.arange(s - S, s, device=new.device) % S
            cl[leaf][:, idx] = new[:, s - S:].to(cl[leaf].dtype)


def _fill_shards(buf, x) -> None:
    """:func:`_fill` of one leaf on a ``DTensor`` cache (the sequence over
    ``tp``, ``dist/sharding.py::cache_specs``), on its local shards: ``x``
    is brought to the cache's placements with the sequence whole, and each
    rank writes the slots it holds, as ``_write_step`` writes one."""
    x = _seq_whole(x, buf)
    local = buf.to_local()
    s, S, n = x.shape[1], buf.shape[1], local.shape[1]
    slots = (L.shard_index(buf.device_mesh, buf.placements, 1) * n
             + torch.arange(n, device=local.device))
    if s <= S:
        held = slots < s
        src = torch.clamp(slots, max=s - 1)
    else:
        # a ring smaller than the prompt: slot j keeps the last position
        # = j (mod S)
        held = torch.ones_like(slots, dtype=torch.bool)
        src = s - S + torch.remainder(slots - (s - S), S)
    local.copy_(torch.where(held[None, :, None, None],
                            x[:, src].to(local.dtype), local))


def prefill_cache(params, tokens, cache, cfg: ModelConfig, ctx: RunCtx,
                  pattern: Optional[Sequence[str]] = None):
    """Fused prefill: one forward pass over the prompt fills the cache.

    tokens (b, s) against a *fresh* cache (``pos`` all zero; whisper's cross
    K/V filled by :func:`prefill_cross_kv`).  Returns (last-position logits
    (b, V) f32, the cache with ``pos`` advanced by s): a
    :class:`ChunkedPrefill` run as one chunk, its mLSTM layers in chunks of
    ``FUSED_MLSTM_CHUNK`` (the whole prompt where 256 does not divide it),
    as the reference's fused prefill runs them.
    """
    job = ChunkedPrefill(params, tokens, cache, cfg, ctx, pattern=pattern,
                         mlstm_chunk=FUSED_MLSTM_CHUNK)
    job.step(job.total)
    return job.finish()

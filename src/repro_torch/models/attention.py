"""Attention entry points: the training attention and the serving path's.

Counterpart of ``repro/models/attention.py``'s ``chunked_attention``,
``context_parallel_attention`` and ``decode_attention``, plus
:func:`paged_decode_attention`, the dispatch the reference's paged decode
makes inline (``models/decode.py::_block_decode``).

* ``backend="kernel"`` (the default) goes through the kernel wrappers in
  ``repro_torch/kernels/`` (the Hopper kernel on CUDA tensors, its plain
  version on CPU tensors), as the reference's ``backend="pallas"`` goes
  through its Pallas kernels.  The kernels have no backward (serving).
* ``backend="torch"`` runs the reference's ``backend="jax"`` algorithm on
  any device.  For ``chunked_attention`` that is the chunked flash with its
  own backward (:class:`_Flash`): the queries in chunks of ``chunk_q``,
  each against the key blocks of ``chunk_k`` that :func:`_extent` leaves,
  in one softmax with the finite ``NEG_INF`` (the reference's online
  softmax over those blocks, reassociated), and a backward that
  recomputes the probabilities from the saved log-sum-exp.  It
  keeps only ``q, k, v, o, lse`` for the backward, so a training layer's
  memory grows as s * chunk, not s^2.  The decode entries run the kernels'
  plain versions.

Softmax statistics and the backward's sums are f32 whatever the inputs'
dtype; outputs and gradients come back in the inputs' dtype.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import is_dtensor
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.flash_attention import (KINDS, check_window,
                                                 flash_attention)
from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                              flash_decode_paged_ref,
                                              flash_decode_ref)
from repro_torch.models.layers import shard_index

BACKENDS = ("kernel", "torch")

# ---------------------------------------------------------------------------
# the chunked flash (the reference's _flash and its custom VJP)


def _extent(kind: str, q_lo: int, q_hi: int, sk: int, window: int,
            chunk_k: int, static_offset: bool) -> Tuple[int, int]:
    """Static KV block range for queries [q_lo, q_hi) (global positions)."""
    if kind in ("causal", "swa") and static_offset:
        k_hi = min(sk, q_hi)
        k_lo = 0
        if kind == "swa" and window > 0:
            k_lo = max(0, q_lo - window + 1)
        k_lo = (k_lo // chunk_k) * chunk_k
        k_hi = -(-k_hi // chunk_k) * chunk_k
        k_hi = max(min(k_hi, sk), k_lo + chunk_k)
        return k_lo, k_hi
    return 0, sk


def _mask(kind: str, qpos, kpos, window: int):
    if kind not in ("causal", "swa"):
        return None
    m = kpos[None, :] <= qpos[:, None]
    if kind == "swa" and window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _scores(qb, kb, qpos, kpos, kind: str, window: int):
    """qb (b, qc, kv, g, hd), kb (b, kc, kv, hd) -> s (b, kv, g, qc, kc) f32,
    masked positions at ``NEG_INF``."""
    scale = qb.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qb.float(), kb.float()) * scale
    m = _mask(kind, qpos, kpos, window)
    if m is not None:
        s = torch.where(m, s, NEG_INF)
    return s


def _chunks(kind, window, q_offset, qpos_base, sq, sk, chunk_q, chunk_k):
    """(q0, qpos of the chunk's first query, k_lo, k_hi) for each query
    chunk: the static block range when ``q_offset`` is an int, all keys
    (mask only) from the traced ``qpos_base`` otherwise."""
    for q0 in range(0, sq, chunk_q):
        if q_offset is not None:
            yield (q0, q_offset + q0) + _extent(
                kind, q_offset + q0, q_offset + q0 + chunk_q, sk, window,
                chunk_k, True)
        else:
            yield q0, qpos_base + q0, 0, sk


def _fwd_qchunk(qb, k, v, qpos0, k_lo, k_hi, kind, window):
    """One query chunk against its key range [k_lo, k_hi): qb (b, qc, kv,
    g, hd) -> (o (b, kv, g, qc, hd) f32, lse (b, kv, g, qc)).

    One softmax over the whole range: the reference's scan over the
    range's key blocks, reassociated.  A masked score is ``NEG_INF``, so it
    weighs exp(NEG_INF - m) = 0 beside any unmasked key, and a fully masked
    row (m = ``NEG_INF``) spreads evenly over the range, as in the scan."""
    qc = qb.shape[1]
    qpos = qpos0 + torch.arange(qc, device=qb.device)
    kpos = k_lo + torch.arange(k_hi - k_lo, device=qb.device)
    s = _scores(qb, k[:, k_lo:k_hi], qpos, kpos, kind, window)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype),
                     v[:, k_lo:k_hi]).float()
    return o / l_safe[..., None], m + torch.log(l_safe)


def _bwd_qchunk(qb, k, v, o, lse, do, qpos0, k_lo, k_hi, kind, window):
    """Flash backward for one query chunk; recomputes its key range's
    probabilities from ``lse``.  The per-block products of the reference's
    scan, done over the whole range at once (each block's dk/dv is its own
    slice; dq sums them).  o/do (b, kv, g, qc, hd) f32, lse
    (b, kv, g, qc) -> (dq (b, qc, kv, g, hd), dk_part, dv_part (b, k_hi -
    k_lo, kv, hd)), all f32."""
    qc, hd = qb.shape[1], qb.shape[-1]
    scale = hd ** -0.5
    qpos = qpos0 + torch.arange(qc, device=qb.device)
    kpos = k_lo + torch.arange(k_hi - k_lo, device=qb.device)
    kb, vb = k[:, k_lo:k_hi], v[:, k_lo:k_hi]
    D = (do * o).sum(dim=-1)                            # (b,kv,g,qc)
    s = _scores(qb, kb, qpos, kpos, kind, window)
    p = torch.exp(s - lse[..., None])                   # (b,kv,g,qc,kc)
    kf, vf = kb.float(), vb.float()
    dv = torch.einsum("bkgqs,bkgqd->bskd", p, do)
    dp = torch.einsum("bkgqd,bskd->bkgqs", do, vf)
    ds = p * (dp - D[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qb.float())
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` with its custom VJP.  q (b, sq, kv, g, hd)
    pre-grouped, k/v (b, sk, kv, hd) -> o (b, kv, g, sq, hd) in q's dtype.
    ``q_offset`` an int: static block skipping; None: the traced offset
    ``qpos_base`` (an int64 tensor) masks only.  Saves q, k, v, o and the
    log-sum-exp; the non-tensor arguments get no gradient, nor does the
    offset."""

    @staticmethod
    def forward(ctx, q, k, v, qpos_base, kind, window, q_offset, chunk_q,
                chunk_k):
        sk = k.shape[1]
        outs, lses = [], []
        for q0, qpos0, k_lo, k_hi in _chunks(kind, window, q_offset,
                                             qpos_base, q.shape[1], sk,
                                             chunk_q, chunk_k):
            o, lse = _fwd_qchunk(q[:, q0:q0 + chunk_q], k, v, qpos0, k_lo,
                                 k_hi, kind, window)
            outs.append(o)
            lses.append(lse)
        out = torch.cat(outs, dim=3).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=3))
        ctx.args = (qpos_base, kind, window, q_offset, chunk_q, chunk_k)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        qpos_base, kind, window, q_offset, chunk_q, chunk_k = ctx.args
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for q0, qpos0, k_lo, k_hi in _chunks(kind, window, q_offset,
                                             qpos_base, q.shape[1],
                                             k.shape[1], chunk_q, chunk_k):
            sl = slice(q0, q0 + chunk_q)
            dq_c, dk_p, dv_p = _bwd_qchunk(
                q[:, sl], k, v, out[:, :, :, sl].float(), lse[..., sl],
                dout[:, :, :, sl].float(), qpos0, k_lo, k_hi, kind, window)
            dq[:, sl] = dq_c
            dk[:, k_lo:k_hi] += dk_p
            dv[:, k_lo:k_hi] += dv_p
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


# ---------------------------------------------------------------------------
# public entry points


def chunked_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                      q_offset=0, chunk_q: int = 512, chunk_k: int = 512,
                      static_offset: bool = True, backend: str = "kernel"):
    """q (b, sq, h, hd); k/v (b, sk, kv, hd) -> (b, sq, h, hd).

    ``q_offset``: global position of q[0] relative to k[0].  An int with
    ``static_offset`` skips the fully masked key blocks; a tensor offset
    (context parallel), or ``static_offset=False``, masks only.

    ``backend="torch"`` runs the chunked flash with its own backward, the
    reference's ``backend="jax"``: ``chunk_q``/``chunk_k`` are snapped to
    ``gcd(min(chunk, s), s)`` (whisper's 1 536 frames under 512 keep 512).
    ``backend="kernel"`` calls the Hopper kernel (forward only, static
    offsets; it picks its own tiles and takes no chunks).  Both refuse a
    ``swa`` call whose last query's window holds no key (``check_window``)
    where the offset is an int.
    """
    if backend == "kernel":
        return flash_attention(q, k, v, kind=kind, window=window,
                               q_offset=int(q_offset))
    if backend != "torch":
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if kind not in KINDS:
        raise ValueError(f"unknown mask kind {kind!r}")
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    if static_offset:
        q_offset = int(q_offset)
    if isinstance(q_offset, int):
        check_window(kind, window, q_offset, sq, sk)
    chunk_q = math.gcd(min(chunk_q, sq), sq)
    chunk_k = math.gcd(min(chunk_k, sk), sk)
    qg = q.reshape(b, sq, kvh, g, hd)
    if static_offset:
        out = _Flash.apply(qg, k, v, None, kind, window, q_offset, chunk_q,
                           chunk_k)
    else:
        base = torch.as_tensor(q_offset, device=q.device).long()
        out = _Flash.apply(qg, k, v, base, kind, window, None, chunk_q,
                           chunk_k)
    # (b, kv, g, sq, hd) -> (b, sq, h, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


class _GatherSeq(torch.autograd.Function):
    """All-gather of a sequence shard (b, s_local, ...) over ``group`` along
    dim 1, with autograd.  The backward sums the gathered gradient over the
    group's ranks and keeps this rank's slice: the transpose of
    ``jax.lax.all_gather(tiled=True)`` under ``shard_map``, done as an
    all-reduce and a slice.  A reduce-scatter would move fewer bytes, and
    gloo runs ``reduce_scatter_tensor`` (torch 2.13 on CPU tensors; 2.11
    on CPU and CUDA tensors), but the all-reduce form is what
    ``tests/test_torch_dist_attention.py`` pins, so it stays."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.s_local = (group, dist.get_rank(group),
                                            x.shape[1])
        return torch.cat(parts, dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = ctx.rank * ctx.s_local
        return grad[:, lo:lo + ctx.s_local].contiguous(), None


def context_parallel_attention(q, k, v, mesh, cp_axis: str, *, kind: str,
                               window: int, chunk_q: int = 512,
                               chunk_k: int = 512):
    """Sequence-sharded attention: the reference's ``shard_map`` body, run
    by each process on its own shard.

    q (b, s_local, h, hd), k/v (b, s_local, kv, hd): this rank's slice of
    the sequence along ``mesh``'s ``cp_axis`` (a
    ``torch.distributed.device_mesh.DeviceMesh``), whose other axes hold
    the batch.  K and V are all-gathered over the axis (with autograd), and
    the queries attend at ``q_offset = rank * s_local`` through the chunked
    flash's traced offset (mask only, no block skipping), with ``chunk_q =
    min(chunk_q, s_local)``.  -> (b, s_local, h, hd).

    A model's attention comes here under ``RunCtx(attn_mode="context")`` on
    a mesh (``models/transformer.py::_attention_fwd``), with each rank's
    local shards of the ``DTensor`` q/k/v.
    """
    group = mesh.get_group(cp_axis)
    s_local = q.shape[1]
    offset = dist.get_rank(group) * s_local
    check_window(kind, window, offset, s_local,
                 s_local * dist.get_world_size(group))
    k_all = _GatherSeq.apply(k, group)
    v_all = _GatherSeq.apply(v, group)
    return chunked_attention(
        q, k_all, v_all, kind=kind, window=window,
        q_offset=torch.tensor(offset, device=q.device),
        chunk_q=min(chunk_q, s_local), chunk_k=chunk_k, static_offset=False,
        backend="torch")


def decode_attention(q, k_cache, v_cache, kv_len, *, backend: str = "kernel",
                     return_lse: bool = False, seq_axis: str = "model"):
    """Single-token attention. q (b, 1, h, hd); caches (b, S, kv, hd).

    ``kv_len`` is a scalar (whole-batch cache length) or a (b,) vector of
    per-slot lengths.  No ``kind``/``window``: a sliding window is carried by
    the ring cache, whose storage order does not matter after RoPE.
    ``return_lse`` also returns the log-sum-exp (b, h) f32 of each (slot,
    head)'s masked scaled scores.

    ``DTensor`` caches (a mesh; ``dist/sharding.py::cache_specs`` puts the
    batch over the data axes and the sequence over ``seq_axis``) decode on
    each rank's local shards: :func:`_sharded_decode`.
    """
    if is_dtensor(k_cache):
        if return_lse:
            raise ValueError("decode_attention on DTensor caches returns o "
                             "alone")
        return _sharded_decode(q, k_cache, v_cache, kv_len, backend,
                               seq_axis)
    if backend == "kernel":
        return flash_decode(q, k_cache, v_cache, kv_len, return_lse)
    if backend == "torch":
        return flash_decode_ref(q, k_cache, v_cache, kv_len, return_lse)
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def _sharded_decode(q, k_cache, v_cache, kv_len, backend: str,
                    seq_axis: str):
    """Flash-decoding across ranks.  Each rank attends its batch rows, with
    every head, over its own chunk of the sequence (q is gathered whole
    over the chunks' mesh dims: it is one token a slot), at ``kv_len_local
    = clamp(kv_len - r * S_local, 0, S_local)`` for chunk r, through
    :func:`decode_attention` with ``return_lse`` (the kernel on the card).
    The chunks' results merge by their log-sum-exp, in f32: m = max over
    ranks of lse, o = sum e^(lse - m) o_r / sum e^(lse - m), one all-reduce
    of the max and one of the weighted sums (o and weight side by side).

    The heads stay whole on every rank, so the GQA grouping never meets a
    sharded dim.  The reference's ``kv_len <= 0`` (the uniform average of
    all S keys, ``NEG_INF`` being finite) holds: a chunk with no valid key
    returns its uniform average at lse ``NEG_INF``, whose weight is 0 beside
    any chunk with a valid key, and equal beside equal chunks that have
    none.  A mesh dim of one rank on ``seq_axis`` holds the sequence as one
    chunk and combines exactly (e^0 = 1, a division by 1); elsewhere the
    merge runs over the mesh dims that shard the sequence.
    -> o (b, 1, h, hd), a ``DTensor`` with the batch as the cache's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, places = k_cache.device_mesh, tuple(k_cache.placements)
    if v_cache.placements != k_cache.placements or any(
            p.is_shard() and p.dim not in (0, 1) or p.is_partial()
            for p in places):
        raise ValueError(f"sharded decode takes caches sharded on the batch "
                         f"and the sequence alone, not {places}")
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in places]
    names = tuple(mesh.mesh_dim_names)
    chunks = [i for i, p in enumerate(places) if p.is_shard(1)
              or (names[i] == seq_axis and mesh.shape[i] == 1)]
    ql = q.redistribute(mesh, rows).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    b_local, s_local = kl.shape[0], kl.shape[1]
    if is_dtensor(kv_len):
        kv_len = kv_len.full_tensor()
    lens = torch.as_tensor(kv_len, device=kl.device).to(torch.int32)
    lens = lens.reshape(-1).expand(k_cache.shape[0])
    r0 = shard_index(mesh, places, 0) * b_local
    s0 = shard_index(mesh, places, 1) * s_local
    lens = torch.clamp(lens[r0:r0 + b_local] - s0, 0, s_local).contiguous()
    o, lse = decode_attention(ql.contiguous(), kl, vl, lens, backend=backend,
                              return_lse=True)
    if chunks:
        def reduced(t, op):
            return DTensor.from_local(
                t, mesh, [Partial(op) if i in chunks else p
                          for i, p in enumerate(rows)]).redistribute(
                mesh, rows).to_local()

        w = torch.exp(lse - reduced(lse, "max"))                 # (b, h)
        tot = reduced(torch.cat([o[:, 0].float() * w[..., None],
                                 w[..., None]], dim=-1), "sum")
        o = (tot[..., :-1] / tot[..., -1:]).to(o.dtype)[:, None]
    return DTensor.from_local(o, mesh, rows)


def paged_decode_attention(q, k_pool, v_pool, bt, kv_len, *,
                           backend: str = "kernel"):
    """Single-token attention through a block table.  q (b, 1, h, hd); pools
    (rows, pg, kv, hd); bt (b, ncols) int32.  ``"kernel"`` resolves the table
    inside the kernel; ``"torch"`` gathers ``pool[bt]`` into the contiguous
    view first, as the reference's jax path does."""
    if backend == "kernel":
        return flash_decode_paged(q, k_pool, v_pool, bt, kv_len)
    if backend == "torch":
        return flash_decode_paged_ref(q, k_pool, v_pool, bt, kv_len)
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")

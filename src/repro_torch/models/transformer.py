"""Model assembly: run context, stack plan, params, training forward, loss.

Counterpart of ``repro/models/transformer.py``.  Params keep the reference's
pytree layout as nested dicts of tensors: ``embed``, ``final_norm``, an
optional ``lm_head``, ``unit`` (the repeating unit of the stack plan, each
leaf stacked over its repeats on axis 0), ``rest`` (remainder layers) and,
for an encoder-decoder, ``encoder`` (``blocks`` stacked over its layers and
its ``final_norm``).  Where the reference scans over a stack, the port walks
it with a Python loop.

The port covers every family and block kind of the reference: ``dense``
(qwen2, qwen1.5, internlm2, mistral-large), ``moe`` (mixtral, llama4: MoE
FFNs from ``models/moe.py``, llama4's shared experts and ``dense_alt``
FFNs), ``hybrid`` (recurrentgemma: RG-LRU blocks from ``models/rglru.py``
beside local attention, the gemma embedding scale), ``ssm`` (xLSTM: mLSTM
and sLSTM blocks from ``models/xlstm.py``, which carry no FFN), ``audio``
(whisper: a bidirectional encoder over stubbed frame embeddings, LayerNorms
with a bias, sinusoidal positions and no RoPE, and a cross-attention in
every decoder block) and ``vlm`` (qwen2-vl: M-RoPE over three position
streams and patch embeddings in place of the first tokens, on the training
forward; serving takes 1-D RoPE, as the reference's).
:func:`check_supported` refuses a family or block kind the reference does
not have.
The training forward (:func:`forward_hidden`, :func:`lm_loss`) is
differentiated by autograd; its attention is ``chunked_attention``'s
``"torch"`` backend, the chunked flash with its own backward at the
context's ``chunk_q``/``chunk_k``, as the reference's training path takes
its jax flash, because the attention kernels have no backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import is_dtensor, resolve_device
from repro_torch.configs.base import (ATTN_FULL, ATTN_LOCAL, ATTN_SWA, MLSTM,
                                      RECURRENT, SLSTM, ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import (chunked_attention,
                                          context_parallel_attention)
from repro_torch.tree import leaves

ATTN_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL)
FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
BLOCK_KINDS = ATTN_KINDS + (RECURRENT, MLSTM, SLSTM)

# ---------------------------------------------------------------------------
# run context


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Execution context: dtypes, attention tiling, kernel dispatch, device.

    ``prefill_backend``/``decode_backend``: ``"kernel"`` routes attention
    through the Hopper kernels (their plain versions on CPU tensors),
    ``"torch"`` through the reference's jax algorithms on any device (the
    chunked flash at prefill, the kernels' plain versions at decode) — the
    reference's ``"pallas"``/``"jax"``.  They govern serving only: the
    training forward (:func:`forward_hidden`) always takes ``"torch"``, as
    the reference's does, since the kernels have no backward.
    ``chunk_q``/``chunk_k`` are the query chunk and key block of
    ``"torch"``'s chunked flash (a cross-attention takes all its queries in
    one chunk, as the reference's); the kernel picks its own tiles and
    ignores them.
    ``remat`` checkpoints each layer of the training forward;
    ``loss_chunk`` is the sequence chunk of :func:`lm_loss`.

    ``mesh`` (a ``DeviceMesh``; ``dist/sharding.py::make_run_ctx`` wires
    it) runs the training forward on ``DTensor``s: ``tp_axis`` and
    ``dp_axes`` name its tensor and data axes, ``attn_mode`` is ``local``,
    ``megatron`` (heads over ``tp_axis``) or ``context`` (the sequence over
    ``tp_axis``, K/V gathered), and ``seq_sharded`` says the batch's
    sequence is sharded (context mode).  Each path forks on its operands:
    ``DTensor``s take the mesh's, plain tensors the single-device one
    (which ``constrain`` leaves unchanged).
    """
    chunk_q: int = 512
    chunk_k: int = 512
    remat: bool = True
    loss_chunk: int = 512
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    decode_backend: str = "kernel"
    prefill_backend: str = "kernel"
    device: str = "cuda"
    mesh: Any = None
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    attn_mode: str = "local"        # local | megatron | context
    seq_sharded: bool = False       # context-parallel activations (b, s@tp, d)

    def constrain(self, x, spec_axes: Tuple[Any, ...]):
        """Redistribute the ``DTensor`` ``x`` to the placements of
        ``spec_axes`` (one entry per dim: an axis name, a tuple of names or
        None), dropping axes that do not divide their dim; its gradient is
        brought back to x's placements.  A plain tensor, or any tensor
        without a mesh, comes back unchanged.

        Sharding propagation can drop the batch axis (replicating all
        compute over ``data``); these pins hold the intended layout
        (DESIGN.md §5).
        """
        if self.mesh is None or not is_dtensor(x):
            return x
        from repro_torch.dist.sharding import placements_of, resolve_axes
        # always through redistribute, even to the same placements: its
        # backward brings the gradient to x's layout, as the transpose of
        # jax's sharding constraint pins the cotangent
        return x.redistribute(self.mesh, placements_of(
            self.mesh, resolve_axes(self.mesh, x.shape, spec_axes)))

    def act(self, x):
        """Pin (b, s, d) activations: batch over the data axes, sequence
        over ``tp_axis`` (Megatron-style sequence parallelism: residuals
        between blocks shard over tp; blocks gather the sequence inside).
        Dims that do not divide stay whole (decode's s = 1)."""
        return self.constrain(x, (self.dp_axes, self.tp_axis, None))


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


def check_supported(cfg: ModelConfig,
                    pattern: Optional[Sequence[str]] = None) -> None:
    """Raise ``ValueError`` unless ``cfg`` (under ``pattern``) is a family
    and every block kind one of the reference's transformer stacks has."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"transformer stack (one of {FAMILIES})")
    kinds = set(pattern if pattern is not None else cfg.pattern)
    kinds.update(kind for kind, _ in layer_sigs(cfg))
    for kind in sorted(kinds):
        if kind not in BLOCK_KINDS:
            raise ValueError(f"{cfg.name}: block kind {kind!r} is not one "
                             f"of {BLOCK_KINDS}")


# ---------------------------------------------------------------------------
# block init / norms


def _init_norm(cfg: ModelConfig, dtype, device):
    """RMSNorm ``scale`` (zeros: the norm multiplies by 1 + scale); the
    audio family's LayerNorm has ``scale`` ones and a ``bias``."""
    if cfg.family == "audio":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    return {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def _norm(p, x, cfg: ModelConfig):
    if "bias" in p:
        return L.layer_norm(x, p["scale"], p["bias"], eps=1e-5)
    return L.rms_norm(x, p["scale"], eps=cfg.norm_eps)


def init_block(gen, cfg: ModelConfig, sig: Tuple[str, str], dtype,
               device, cross_attn: bool = False) -> Dict[str, Any]:
    """One block of signature ``sig`` = (kind, ffn kind); ``cross_attn``
    adds whisper's cross-attention (``cross``, ``norm_cross``)."""
    kind, ffn = sig
    p: Dict[str, Any] = {"norm1": _init_norm(cfg, dtype, device)}
    if kind == RECURRENT:
        p["rglru"] = rglru_lib.init_rglru(gen, cfg, dtype, device)
    elif kind == MLSTM:
        p["mlstm"] = xlstm_lib.init_mlstm(gen, cfg, dtype, device)
    elif kind == SLSTM:
        p["slstm"] = xlstm_lib.init_slstm(gen, cfg, dtype, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
    if cross_attn:
        p["cross"] = L.init_attention(gen, cfg, dtype, device)
        p["norm_cross"] = _init_norm(cfg, dtype, device)
    if ffn != "none":
        p["norm2"] = _init_norm(cfg, dtype, device)
        if ffn == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device)
        else:
            d_ff = cfg.moe.dense_d_ff if ffn == "dense_alt" else cfg.d_ff
            p["mlp"] = L.init_mlp(gen, cfg.d_model, d_ff, dtype, device)
    return p


def ffn_fwd(p, x, cfg: ModelConfig, ffn: str, ctx: Optional[RunCtx] = None):
    """The block's FFN half: x + FFN(norm2(x)) -> (x, aux loss or None);
    ``ctx`` pins the FFN's activations on its mesh."""
    if ffn == "none":
        return x, None
    h = _norm(p["norm2"], x, cfg)
    if ffn == "moe":
        y, aux = moe_lib.moe_ffn(p["moe"], h, cfg, ctx)
        return x + y, aux
    return x + L.mlp(p["mlp"], h, ctx), None


def sinusoidal(positions, d: int):
    """Whisper's absolute positions: positions (...) -> (..., d) f32, the
    sines of ``d // 2`` frequencies, then their cosines."""
    half = d // 2
    freq = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed(params, tokens, cfg: ModelConfig, ctx: "RunCtx", positions=None):
    """Token embeddings in the compute dtype; the hybrid family scales them
    by sqrt(d_model), as gemma does, and the audio family adds the
    sinusoidal positions of ``positions`` (broadcast against (b, s))."""
    # the embedding op, not an index: DTensor (torch 2.11) has no working
    # strategy for the index's backward
    x = F.embedding(ctx.constrain(tokens, (ctx.dp_axes, None)),
                    params["embed"])
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        # replicated tokens (a batch the data axes do not divide) looked up
        # in the vocab-sharded table leave a masked partial sum: reduced
        # here, once, since DTensor can reduce it neither twice nor after
        # resharding another of its dims
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    x = x.to(ctx.compute_dtype)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.family == "audio":
        if positions is None:
            raise ValueError(f"{cfg.name}: the audio family's embedding "
                             "needs positions")
        pos, = L.beside(x, sinusoidal(positions, cfg.d_model).to(x.dtype))
        x = x + pos
    return x


def rope_for(cfg: ModelConfig, positions, mrope_positions=None):
    """(cos, sin) of the stack's rotary embedding at ``positions``, M-RoPE's
    at ``mrope_positions`` where the config uses it and they are given, or
    (None, None) for the audio family, which has none."""
    if cfg.family == "audio":
        return None, None
    hd = cfg.resolved_head_dim
    if cfg.use_mrope and mrope_positions is not None:
        return L.mrope_angles(mrope_positions, hd, cfg.mrope_sections,
                              cfg.rope_theta)
    return L.rope_angles(positions, hd, cfg.rope_theta)


def rotate(q, k, rope):
    """q and k under (cos, sin) ``rope``; unchanged where it is (None,
    None)."""
    cos, sin = rope
    if cos is None:
        return q, k
    return L.apply_rotary(q, cos, sin), L.apply_rotary(k, cos, sin)


def _effective(cfg: ModelConfig, pattern, li):
    """(kind, window) of layer ``li`` under ``pattern``: a long-context
    variant runs a full-attention layer of the training pattern as SWA with
    ``long_context_variant_window``; the params are the same."""
    kind = pattern[li]
    window = cfg.window_size
    if cfg.pattern[li] == ATTN_FULL and kind == ATTN_SWA:
        window = cfg.long_context_variant_window
    return kind, window


def _init_stacked(make, reps: int) -> Dict[str, Any]:
    """``reps`` trees from ``make()``, each leaf stacked on a new axis 0.
    Each tree is copied into the stack as it is made, so at most one
    unstacked tree is alive beside the stack."""
    def alloc(t):
        return {k: alloc(v) if isinstance(v, dict) else
                torch.empty((reps,) + v.shape, dtype=v.dtype, device=v.device)
                for k, v in t.items()}

    def put(dst, t, r):
        for k, v in t.items():
            if isinstance(v, dict):
                put(dst[k], v, r)
            else:
                dst[k][r] = v

    out = None
    for r in range(reps):
        tree = make()
        if out is None:
            out = alloc(tree)
        put(out, tree, r)
        del tree            # before the next make(): one tree at a time
    return out


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
    cross = cfg.encoder_layers > 0
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.padded_vocab_size, cfg.d_model, dtype,
                              dev),
        "final_norm": _init_norm(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                         cfg.padded_vocab_size, dtype, dev)
    params["unit"] = {
        f"p{j}": _init_stacked(
            lambda: init_block(gen, cfg, sigs[j], dtype, dev, cross), reps)
        for j in range(u)}
    params["rest"] = {
        f"l{u * reps + i}": init_block(gen, cfg, sigs[u * reps + i], dtype,
                                       dev, cross)
        for i in range(rem)}
    if cross:
        params["encoder"] = {
            "blocks": _init_stacked(
                lambda: init_block(gen, cfg, ENCODER_SIG, dtype, dev),
                cfg.encoder_layers),
            "final_norm": _init_norm(cfg, dtype, dev)}
    return params


def param_count_tree(params) -> int:
    """The number of elements over every leaf of ``params`` (meta tensors
    included)."""
    return int(sum(x.numel() for x in leaves(params)))


# ---------------------------------------------------------------------------
# forward (train)

_MASK = {ATTN_FULL: "causal", ATTN_SWA: "swa", ATTN_LOCAL: "swa",
         "bidir": "bidir"}
ENCODER_SIG = (ATTN_FULL, "dense")


def _attention_fwd(p, x, cfg: ModelConfig, ctx: RunCtx, eff_kind: str,
                   window: int, rope, backend: str):
    q, k, v = L.qkv_proj(p, x, cfg)
    q, k = rotate(q, k, rope)
    kind = _MASK[eff_kind]
    if not is_dtensor(q):
        o = chunked_attention(q, k, v, kind=kind, window=window,
                              chunk_q=ctx.chunk_q, chunk_k=ctx.chunk_k,
                              backend=backend)
    elif ctx.attn_mode == "context" and x.shape[1] > 1:
        o = _context_attention(q, k, v, ctx, kind, window)
    else:
        o = _head_sharded_attention(q, k, v, ctx, kind, window, ctx.chunk_q,
                                    backend)
    return L.out_proj(p, o)


def _partial_grads(x, used_by):
    """Gradient placements of the local shard of ``x`` when a computation
    that only covers ``used_by``'s shard reads it: ``Partial`` on each mesh
    dim where ``used_by`` is sharded and ``x`` replicated (each rank then
    holds its share of the gradient), ``x``'s own placement elsewhere."""
    from torch.distributed.tensor import Partial
    return [Partial() if pu.is_shard() and px.is_replicate() else px
            for px, pu in zip(x.placements, used_by.placements)]


def _head_sharded_attention(q, k, v, ctx: RunCtx, kind: str, window: int,
                            chunk_q: int, backend: str, q_offset: int = 0):
    """Megatron attention on the mesh: queries sharded on heads over
    ``tp_axis`` (the sequence gathered), K/V replicated over it; each rank
    runs the chunked flash, an autograd Function DTensor cannot shard (or,
    serving, the kernel on ``backend``), on its local heads and the KV heads
    they read, the queries at ``q_offset``.  -> o (b, s, h, hd) with q's
    placements."""
    from torch.distributed.tensor import DTensor
    dp, tp = ctx.dp_axes, ctx.tp_axis
    q = ctx.constrain(q, (dp, None, tp, None))
    k = ctx.constrain(k, (dp, None, None, None))
    v = ctx.constrain(v, (dp, None, None, None))
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    ql = q.to_local()
    hl = ql.shape[2]
    h0 = q.device_mesh.get_local_rank(tp) * hl if hl < h else 0
    kl = k.to_local(grad_placements=_partial_grads(k, q))
    vl = v.to_local(grad_placements=_partial_grads(v, q))
    if h0 % g == 0 and hl % g == 0:
        # whole groups: their KV heads, in order
        kl, vl = (t[:, :, h0 // g:(h0 + hl) // g] for t in (kl, vl))
    else:
        # a group split over ranks: one KV head for each query head
        idx = torch.div(torch.arange(h0, h0 + hl, device=kl.device), g,
                        rounding_mode="floor")
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    o = chunked_attention(ql, kl, vl, kind=kind, window=window,
                          q_offset=q_offset, chunk_q=chunk_q,
                          chunk_k=ctx.chunk_k, backend=backend)
    return DTensor.from_local(o, q.device_mesh, q.placements)


def _context_attention(q, k, v, ctx: RunCtx, kind: str, window: int):
    """Context-parallel attention on the mesh: q/k/v sequence-sharded over
    ``tp_axis``; ``context_parallel_attention`` on each rank's shards, which
    gathers the K/V along the sequence.  -> o with q's placements."""
    from torch.distributed.tensor import DTensor, Shard
    dp, tp = ctx.dp_axes, ctx.tp_axis
    q, k, v = (ctx.constrain(t, (dp, tp, None, None)) for t in (q, k, v))
    mesh = q.device_mesh
    if q.placements[mesh.mesh_dim_names.index(tp)] != Shard(1):
        raise ValueError(f"context attention: sequence {q.shape[1]} does not "
                         f"divide over {tp!r}")
    o = context_parallel_attention(q.to_local(), k.to_local(), v.to_local(),
                                   mesh, tp, kind=kind, window=window,
                                   chunk_q=ctx.chunk_q, chunk_k=ctx.chunk_k)
    return DTensor.from_local(o, mesh, q.placements)


def cross_query(p, x, cfg: ModelConfig):
    """The cross-attention's queries (b, s, h, hd): ``qkv_proj``'s q alone
    (the reference projects k and v from ``x`` too, and drops them)."""
    q = L.dense(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    return L.split_heads(q, cfg.num_heads, cfg.resolved_head_dim)


def cross_attention(p, x, ck, cv, cfg: ModelConfig, ctx: RunCtx,
                    backend: str):
    """Whisper's cross-attention: queries from ``x``, keys and values the
    encoder's (ck, cv) (b, enc_s, kv, hd), no mask; all queries in one
    chunk, as the reference's."""
    q = cross_query(p, x, cfg)
    if is_dtensor(q):
        o = _head_sharded_attention(q, ck, cv, ctx, "bidir", 0, x.shape[1],
                                    backend)
    else:
        o = chunked_attention(q, ck, cv, kind="bidir", chunk_q=x.shape[1],
                              chunk_k=ctx.chunk_k, backend=backend)
    return L.out_proj(p, o)


def proj_cross(bp, enc_out, cfg: ModelConfig):
    """One decoder block's cross K/V (b, enc_s, kv, hd) from the encoder's
    output, by its own ``wk``/``wv`` (no bias, as the reference)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (L.split_heads(L.dense(enc_out, bp["cross"]["wk"]), kv, hd),
            L.split_heads(L.dense(enc_out, bp["cross"]["wv"]), kv, hd))


def block_fwd(p, x, cfg: ModelConfig, ctx: RunCtx, sig: Tuple[str, str],
              eff_kind: str, window: int, rope, enc_out=None,
              backend: str = "torch"):
    """One block, training path. x (b, s, d) -> (x, aux loss f32).
    ``enc_out``: the encoder's output, for a block with cross-attention;
    ``backend``: the attention's (``"torch"``, the chunked flash, unless
    serving)."""
    kind, ffn = sig
    h = _norm(p["norm1"], x, cfg)
    if kind in (RECURRENT, MLSTM, SLSTM):
        # recurrent scans need the sequence local; features shard instead
        h = ctx.constrain(h, (ctx.dp_axes, None, None))
    if kind == RECURRENT:
        x = x + rglru_lib.rglru_block(p["rglru"], h)
    elif kind == MLSTM:
        x = x + xlstm_lib.mlstm_chunked(p["mlstm"], h, cfg,
                                        chunk=min(256, h.shape[1]))
    elif kind == SLSTM:
        x = x + xlstm_lib.slstm_block(p["slstm"], h, cfg)
    else:
        x = x + _attention_fwd(p["attn"], h, cfg, ctx, eff_kind, window,
                               rope, backend)
    if enc_out is not None:
        hc = _norm(p["norm_cross"], x, cfg)
        x = x + cross_attention(p["cross"], hc, *proj_cross(p, enc_out, cfg),
                                cfg, ctx, backend)
    x, aux = ffn_fwd(p, x, cfg, ffn, ctx)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _unbind(tree: Dict[str, Any], reps: int) -> List[Dict[str, Any]]:
    """The ``reps`` repeats of a stacked tree, each leaf unbound once: the
    backward of ``unbind`` stacks the layer gradients in one copy, where
    indexing each layer would add a full-size gradient per layer."""
    per_leaf = {k: (_unbind(v, reps) if isinstance(v, dict)
                    else torch.unbind(v, 0)) for k, v in tree.items()}
    return [{k: v[r] for k, v in per_leaf.items()} for r in range(reps)]


def encode(params, feats, cfg: ModelConfig, ctx: RunCtx,
           backend: str = "torch"):
    """Whisper's encoder: feats (b, enc_s, d_model), the stubbed conv
    front end's output -> (b, enc_s, d_model) after its final norm.  Its
    blocks attend bidirectionally on ``backend``: ``"torch"`` (the chunked
    flash at ``ctx``'s chunks) on the training forward,
    ``ctx.prefill_backend`` when serving (``decode.prefill_cross_kv``).  ``ctx.remat`` checkpoints each layer
    where autograd is on."""
    x = feats.to(ctx.compute_dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    sin_pos, = L.beside(x, sinusoidal(pos, cfg.d_model).to(x.dtype)[None])
    x = x + sin_pos
    remat = ctx.remat and torch.is_grad_enabled()

    def body(x, bp):
        return ctx.act(block_fwd(bp, x, cfg, ctx, ENCODER_SIG, "bidir", 0,
                                 (None, None), backend=backend)[0])

    enc = params["encoder"]
    for bp in _unbind(enc["blocks"], cfg.encoder_layers):
        x = (checkpoint(body, x, bp, use_reentrant=False) if remat
             else body(x, bp))
    return _norm(enc["final_norm"], x, cfg)


def forward_hidden(params, tokens, cfg: ModelConfig, ctx: RunCtx,
                   pattern: Optional[Sequence[str]] = None,
                   mrope_positions=None, patch_embeds=None, audio_feats=None,
                   positions=None):
    """tokens (b, s) -> (hidden (b, s, d) after the final norm, aux loss).

    ``patch_embeds`` (b, np, d) take the place of the first np token
    embeddings and ``mrope_positions`` (3, b, s) drive M-RoPE (qwen2-vl);
    ``audio_feats`` (b, enc_s, d) feed the encoder (whisper, which needs
    them).  The aux loss is the sum over MoE layers of their load-balance
    losses (0 without MoE layers).  ``ctx.remat`` checkpoints each repeat of
    the stack unit, as the reference's ``jax.checkpoint(unit_body)``.
    """
    check_supported(cfg, pattern)
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    sigs = layer_sigs(cfg)
    u, reps, rem = stack_plan(sigs)
    s = tokens.shape[1]
    seq = torch.arange(s, device=tokens.device)
    x = ctx.act(embed(params, tokens, cfg, ctx, positions=seq))
    if patch_embeds is not None:
        npk = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, npk:]], dim=1)
    if is_dtensor(mrope_positions):
        # integer positions, gathered whole: the tables are built plain
        # and replicated (DTensor refuses the plain frequencies beside them)
        mrope_positions = mrope_positions.full_tensor()
    rope = L.beside(x, *rope_for(cfg, seq if positions is None else positions,
                                 mrope_positions))
    enc_out = None
    if cfg.encoder_layers:
        if audio_feats is None:
            raise ValueError(f"{cfg.name}: the encoder needs audio_feats")
        # each decoder block projects its own cross K/V from this output
        enc_out = encode(params, audio_feats, cfg, ctx)

    def unit_body(x, aux, unit_p):
        for j in range(u):
            kind, window = _effective(cfg, pattern, j)  # periodic: li % u == j
            x, a = block_fwd(unit_p[f"p{j}"], x, cfg, ctx, sigs[j], kind,
                             window, rope, enc_out)
            x = ctx.act(x)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit_p in _unbind(params["unit"], reps):
        x, aux = (checkpoint(unit_body, x, aux, unit_p, use_reentrant=False)
                  if ctx.remat else unit_body(x, aux, unit_p))
    for i in range(rem):
        li = u * reps + i
        kind, window = _effective(cfg, pattern, li)
        x, a = block_fwd(params["rest"][f"l{li}"], x, cfg, ctx, sigs[li],
                         kind, window, rope, enc_out)
        aux = aux + a
    x = ctx.act(_norm(params["final_norm"], x, cfg))
    return x, aux


# ---------------------------------------------------------------------------
# loss


def _lm_head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _chunk_nll(h, lab, m, head, ctx: RunCtx):
    # vocab-sharded logits on a mesh
    logits = ctx.constrain(L.dense(h, head).float(),
                           (ctx.dp_axes, None, ctx.tp_axis))
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        gold = _gold_sharded(logits, lab, ctx)
    else:
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    return torch.sum((lse - gold) * m)


def _gold_sharded(logits, lab, ctx: RunCtx):
    """The label's logit from vocab-sharded ``DTensor`` logits (b, c, V):
    each rank gathers from its own vocab slice (0 where the label lies in
    another's), so the result is partial over the vocab's mesh dim and its
    gradient is whole on every rank.  (DTensor's own gather over the
    sharded dim fails in its mask bookkeeping.)"""
    from torch.distributed.tensor import Partial, Replicate
    mesh = logits.device_mesh
    lab = ctx.constrain(lab, (ctx.dp_axes, None))
    ll, labl = logits.to_local(), lab.to_local().long()
    v0, out, grad = 0, [], []
    for i, p in enumerate(logits.placements):
        if p.is_shard(2):
            v0 = mesh.get_local_rank(i) * ll.shape[-1]
            out.append(Partial())
            grad.append(Replicate())
        else:
            out.append(p)
            grad.append(p)
    mine = (labl >= v0) & (labl < v0 + ll.shape[-1])
    idx = torch.clamp(labl - v0, 0, ll.shape[-1] - 1)
    g = torch.where(mine, torch.gather(ll, -1, idx[..., None])[..., 0],
                    torch.zeros((), dtype=ll.dtype, device=ll.device))
    return L.from_shards(g, mesh, out, grad)


def lm_loss(params, hidden, labels, cfg: ModelConfig, ctx: RunCtx,
            loss_mask=None, normalize: bool = True):
    """Chunked softmax cross-entropy; the (b, s, V) logits never exist whole.

    hidden (b, s, d); labels (b, s) int.  Each sequence chunk of
    ``ctx.loss_chunk`` is checkpointed, so the backward recomputes its
    logits instead of keeping them.  Returns the mean nll over valid tokens
    (the masked sum if not ``normalize``).
    """
    head = _lm_head(params, cfg)
    b, s, _ = hidden.shape
    c = min(ctx.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    if loss_mask is None:
        loss_mask = torch.ones_like(labels, dtype=torch.float32)
    # the chunks slice the sequence: gather it once (context mode shards it)
    hidden = ctx.constrain(hidden, (ctx.dp_axes, None, None))
    labels, loss_mask = (ctx.constrain(t, (ctx.dp_axes, None))
                         for t in (labels, loss_mask))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        total = total + checkpoint(_chunk_nll, hidden[:, i:i + c],
                                   labels[:, i:i + c], loss_mask[:, i:i + c],
                                   head, ctx, use_reentrant=False)
    if not normalize:
        return total
    return total / torch.clamp(torch.sum(loss_mask), min=1.0)


def logits_fn(params, hidden, cfg: ModelConfig):
    return torch.matmul(hidden, _lm_head(params, cfg)).float()

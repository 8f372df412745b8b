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
differentiated by autograd; its attention is the plain version, as the
reference's training path takes its jax attention, because the attention
kernels have no backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN_FULL, ATTN_LOCAL, ATTN_SWA, MLSTM,
                                      RECURRENT, SLSTM, ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import chunked_attention
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
    ``"torch"`` through the plain versions everywhere — the reference's
    ``"pallas"``/``"jax"``.  They govern serving only: the training forward
    (:func:`forward_hidden`) always takes the plain attention, as the
    reference's does, since the kernels have no backward.  ``chunk_q``/
    ``chunk_k`` mirror the reference's fields and are unused by the port:
    the kernel picks its own tiles and the plain version takes none.
    ``remat`` checkpoints each layer of the training forward;
    ``loss_chunk`` is the sequence chunk of :func:`lm_loss`.
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


def ffn_fwd(p, x, cfg: ModelConfig, ffn: str):
    """The block's FFN half: x + FFN(norm2(x)) -> (x, aux loss or None)."""
    if ffn == "none":
        return x, None
    h = _norm(p["norm2"], x, cfg)
    if ffn == "moe":
        y, aux = moe_lib.moe_ffn(p["moe"], h, cfg)
        return x + y, aux
    return x + L.mlp(p["mlp"], h), None


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
    x = params["embed"][tokens].to(ctx.compute_dtype)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.family == "audio":
        if positions is None:
            raise ValueError(f"{cfg.name}: the audio family's embedding "
                             "needs positions")
        x = x + sinusoidal(positions, cfg.d_model).to(x.dtype)
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


def _attention_fwd(p, x, cfg: ModelConfig, eff_kind: str, window: int, rope,
                   backend: str):
    q, k, v = L.qkv_proj(p, x, cfg)
    q, k = rotate(q, k, rope)
    o = chunked_attention(q, k, v, kind=_MASK[eff_kind], window=window,
                          backend=backend)
    return L.out_proj(p, o)


def cross_query(p, x, cfg: ModelConfig):
    """The cross-attention's queries (b, s, h, hd): ``qkv_proj``'s q alone
    (the reference projects k and v from ``x`` too, and drops them)."""
    b, s, _ = x.shape
    q = torch.matmul(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    return q.reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)


def cross_attention(p, x, ck, cv, cfg: ModelConfig, backend: str):
    """Whisper's cross-attention: queries from ``x``, keys and values the
    encoder's (ck, cv) (b, enc_s, kv, hd), no mask."""
    o = chunked_attention(cross_query(p, x, cfg), ck, cv, kind="bidir",
                          backend=backend)
    return L.out_proj(p, o)


def proj_cross(bp, enc_out, cfg: ModelConfig):
    """One decoder block's cross K/V (b, enc_s, kv, hd) from the encoder's
    output, by its own ``wk``/``wv`` (no bias, as the reference)."""
    b, s, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (torch.matmul(enc_out, bp["cross"]["wk"]).reshape(b, s, kv, hd),
            torch.matmul(enc_out, bp["cross"]["wv"]).reshape(b, s, kv, hd))


def block_fwd(p, x, cfg: ModelConfig, sig: Tuple[str, str], eff_kind: str,
              window: int, rope, enc_out=None, backend: str = "torch"):
    """One block, training path. x (b, s, d) -> (x, aux loss f32).
    ``enc_out``: the encoder's output, for a block with cross-attention;
    ``backend``: the attention's (the plain version unless serving)."""
    kind, ffn = sig
    h = _norm(p["norm1"], x, cfg)
    if kind == RECURRENT:
        x = x + rglru_lib.rglru_block(p["rglru"], h)
    elif kind == MLSTM:
        x = x + xlstm_lib.mlstm_chunked(p["mlstm"], h, cfg,
                                        chunk=min(256, h.shape[1]))
    elif kind == SLSTM:
        x = x + xlstm_lib.slstm_block(p["slstm"], h, cfg)
    else:
        x = x + _attention_fwd(p["attn"], h, cfg, eff_kind, window, rope,
                               backend)
    if enc_out is not None:
        hc = _norm(p["norm_cross"], x, cfg)
        x = x + cross_attention(p["cross"], hc, *proj_cross(p, enc_out, cfg),
                                cfg, backend)
    x, aux = ffn_fwd(p, x, cfg, ffn)
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
    blocks attend bidirectionally on ``backend``: the plain version on the
    training forward, ``ctx.prefill_backend`` when serving
    (``decode.prefill_cross_kv``).  ``ctx.remat`` checkpoints each layer
    where autograd is on."""
    x = feats.to(ctx.compute_dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)[None]
    remat = ctx.remat and torch.is_grad_enabled()

    def body(x, bp):
        return block_fwd(bp, x, cfg, ENCODER_SIG, "bidir", 0, (None, None),
                         backend=backend)[0]

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
    x = embed(params, tokens, cfg, ctx, positions=seq)
    if patch_embeds is not None:
        npk = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, npk:]], dim=1)
    rope = rope_for(cfg, seq if positions is None else positions,
                    mrope_positions)
    enc_out = None
    if cfg.encoder_layers:
        if audio_feats is None:
            raise ValueError(f"{cfg.name}: the encoder needs audio_feats")
        # each decoder block projects its own cross K/V from this output
        enc_out = encode(params, audio_feats, cfg, ctx)

    def unit_body(x, aux, unit_p):
        for j in range(u):
            kind, window = _effective(cfg, pattern, j)  # periodic: li % u == j
            x, a = block_fwd(unit_p[f"p{j}"], x, cfg, sigs[j], kind, window,
                             rope, enc_out)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit_p in _unbind(params["unit"], reps):
        x, aux = (checkpoint(unit_body, x, aux, unit_p, use_reentrant=False)
                  if ctx.remat else unit_body(x, aux, unit_p))
    for i in range(rem):
        li = u * reps + i
        kind, window = _effective(cfg, pattern, li)
        x, a = block_fwd(params["rest"][f"l{li}"], x, cfg, sigs[li], kind,
                         window, rope, enc_out)
        aux = aux + a
    x = _norm(params["final_norm"], x, cfg)
    return x, aux


# ---------------------------------------------------------------------------
# loss


def _lm_head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _chunk_nll(h, lab, m, head):
    logits = torch.matmul(h, head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    return torch.sum((lse - gold) * m)


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
        loss_mask = torch.ones((b, s), dtype=torch.float32,
                               device=hidden.device)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        total = total + checkpoint(_chunk_nll, hidden[:, i:i + c],
                                   labels[:, i:i + c], loss_mask[:, i:i + c],
                                   head, use_reentrant=False)
    if not normalize:
        return total
    return total / torch.clamp(torch.sum(loss_mask), min=1.0)


def logits_fn(params, hidden, cfg: ModelConfig):
    return torch.matmul(hidden, _lm_head(params, cfg)).float()

"""Model assembly: run context, stack plan, params, training forward, loss.

Counterpart of ``repro/models/transformer.py``.  Params keep the reference's
pytree layout as nested dicts of tensors: ``embed``, ``final_norm``, an
optional ``lm_head``, ``unit`` (the repeating unit of the stack plan, each
leaf stacked over its repeats on axis 0) and ``rest`` (remainder layers).
Where the reference scans over the stacked unit, the port walks it with a
Python loop.

The port covers the ``dense`` family (qwen2, qwen1.5, internlm2,
mistral-large: attention blocks with dense FFNs), the ``moe`` family
(mixtral, llama4: MoE FFNs from ``models/moe.py``, with llama4's shared
experts and interleaved ``dense_alt`` FFNs) and the ``hybrid`` family
(recurrentgemma: RG-LRU blocks from ``models/rglru.py`` beside local
attention, and the gemma embedding scale).  Every other family or block
kind raises ``NotImplementedError`` naming the ROADMAP item that will port
it.  The training forward (:func:`forward_hidden`, :func:`lm_loss`) is
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
from repro_torch.models.attention import chunked_attention

ATTN_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL)
FAMILIES = ("dense", "moe", "hybrid")
BLOCK_KINDS = ATTN_KINDS + (RECURRENT,)

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


_NOT_PORTED = ("ROADMAP.md, 'Modules to port': the serving model zoo "
               "(xLSTM, whisper and VLM blocks)")


def check_supported(cfg: ModelConfig,
                    pattern: Optional[Sequence[str]] = None) -> None:
    """Raise ``NotImplementedError`` unless the port serves ``cfg``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({_NOT_PORTED})")
    kinds = set(pattern if pattern is not None else cfg.pattern)
    kinds.update(kind for kind, _ in layer_sigs(cfg))
    for kind in kinds:
        if kind not in BLOCK_KINDS:
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


def init_block(gen, cfg: ModelConfig, sig: Tuple[str, str], dtype,
               device) -> Dict[str, Any]:
    """One block of signature ``sig`` = (kind, ffn kind)."""
    kind, ffn = sig
    p: Dict[str, Any] = {"norm1": _init_norm(cfg, dtype, device)}
    if kind == RECURRENT:
        p["rglru"] = rglru_lib.init_rglru(gen, cfg, dtype, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
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


def embed(params, tokens, cfg: ModelConfig, ctx: "RunCtx"):
    """Token embeddings in the compute dtype; the hybrid family scales them
    by sqrt(d_model), as gemma does."""
    x = params["embed"][tokens].to(ctx.compute_dtype)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


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
            lambda: init_block(gen, cfg, sigs[j], dtype, dev), reps)
        for j in range(u)}
    params["rest"] = {
        f"l{u * reps + i}": init_block(gen, cfg, sigs[u * reps + i], dtype,
                                       dev)
        for i in range(rem)}
    return params


# ---------------------------------------------------------------------------
# forward (train)

_MASK = {ATTN_FULL: "causal", ATTN_SWA: "swa", ATTN_LOCAL: "swa"}


def _attention_fwd(p, x, cfg: ModelConfig, eff_kind: str, window: int, rope):
    cos, sin = rope
    q, k, v = L.qkv_proj(p, x, cfg)
    q = L.apply_rotary(q, cos, sin)
    k = L.apply_rotary(k, cos, sin)
    o = chunked_attention(q, k, v, kind=_MASK[eff_kind], window=window,
                          backend="torch")
    return L.out_proj(p, o)


def block_fwd(p, x, cfg: ModelConfig, sig: Tuple[str, str], eff_kind: str,
              window: int, rope):
    """One block, training path. x (b, s, d) -> (x, aux loss f32)."""
    kind, ffn = sig
    h = _norm(p["norm1"], x, cfg)
    if kind == RECURRENT:
        x = x + rglru_lib.rglru_block(p["rglru"], h)
    else:
        x = x + _attention_fwd(p["attn"], h, cfg, eff_kind, window, rope)
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


def forward_hidden(params, tokens, cfg: ModelConfig, ctx: RunCtx,
                   pattern: Optional[Sequence[str]] = None, positions=None):
    """tokens (b, s) -> (hidden (b, s, d) after the final norm, aux loss).

    The aux loss is the sum over MoE layers of their load-balance losses (0
    without MoE layers).  ``ctx.remat`` checkpoints each repeat of the stack
    unit, as the reference's ``jax.checkpoint(unit_body)``.
    """
    check_supported(cfg, pattern)
    pattern = tuple(pattern) if pattern is not None else cfg.pattern
    sigs = layer_sigs(cfg)
    u, reps, rem = stack_plan(sigs)
    x = embed(params, tokens, cfg, ctx)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)
    rope = L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def unit_body(x, aux, unit_p):
        for j in range(u):
            kind, window = _effective(cfg, pattern, j)  # periodic: li % u == j
            x, a = block_fwd(unit_p[f"p{j}"], x, cfg, sigs[j], kind, window,
                             rope)
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
                         window, rope)
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

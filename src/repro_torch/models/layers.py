"""Core layers: norms, rotary embeddings, projections, gated MLP.

Counterpart of ``repro/models/layers.py`` for the serving slice.  Params are
plain dicts of tensors with the reference's names and layouts (``(d_in,
d_out)`` weights), so converted reference params drop straight in.  Init
functions take an explicit :class:`torch.Generator`; the big projections stay
``torch.matmul``, as the reference left them to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# init helpers


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., s) -> cos/sin of shape (..., s, head_dim//2)."""
    half = head_dim // 2
    freq = float(theta) ** (-torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin):
    """x (b, s, h, hd); cos/sin (b, s, hd//2) or (s, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:  # (s, half)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:              # (b, s, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP


def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype,
             device) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device),
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
    }


def mlp(params, x):
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    return torch.matmul(F.silu(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# attention projections


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> Dict[str, torch.Tensor]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, kv * hd, dtype, device),
        "wv": dense_init(gen, d, kv * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    return p


def qkv_proj(params, x, cfg: ModelConfig):
    """x (b, s, d) -> q (b, s, h, hd), k/v (b, s, kv, hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.matmul(x, params["wq"])
    k = torch.matmul(x, params["wk"])
    v = torch.matmul(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd),
            v.reshape(b, s, kv, hd))


def out_proj(params, attn_out):
    b, s, h, hd = attn_out.shape
    return torch.matmul(attn_out.reshape(b, s, h * hd), params["wo"])

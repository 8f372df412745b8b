"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.  The Real-Gated Linear Recurrent
Unit is a linear diagonal recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t)),      c = 8

The block: x -> [gate branch: GeLU (tanh form)] x [recurrent branch: causal
depthwise conv (width 4) -> RG-LRU] -> elementwise product -> out-proj.
Decode keeps (h, conv taps) as the layer's state; ``lam``, ``b_a``, ``b_i``
and ``h`` stay f32.

The reference runs the recurrence as ``jax.lax.associative_scan`` per chunk
of the sequence, with the state carried from chunk to chunk.  Torch has no
associative scan, so :func:`_scan` is a plain log-depth (Hillis-Steele)
scan over each chunk on the same combine: ceil(log2(chunk)) elementwise
passes over the chunk.  The two scans add the same terms in different
trees, so they agree to rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

_C = 8.0
_CONV_W = 4


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    r = cfg.lru_dim or d
    # Lambda such that a = exp(-c softplus(Lambda)) at a fully open gate is
    # uniform in (0.9^2, 0.999^2), as the reference draws it
    u = torch.empty((r,), dtype=torch.float32, device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))    # inverse softplus
    conv_w = torch.randn((_CONV_W, r), generator=gen, dtype=torch.float32,
                         device=device) / _CONV_W
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_rec_in": dense_init(gen, d, r, dtype, device),
        "w_gate_in": dense_init(gen, d, r, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((r,), dtype=dtype, device=device),
        "w_a": dense_init(gen, r, r, dtype, device),
        "b_a": torch.zeros((r,), **f32),
        "w_i": dense_init(gen, r, r, dtype, device),
        "b_i": torch.zeros((r,), **f32),
        "lam": lam,
        "w_out": dense_init(gen, r, d, dtype, device),
    }


def _gates(params, u):
    """u (..., r) -> log_a (f32), gated input (f32)."""
    ra = torch.sigmoid(torch.matmul(u, params["w_a"]).float() + params["b_a"])
    log_a = -_C * F.softplus(params["lam"]) * ra
    gi = torch.sigmoid(torch.matmul(u, params["w_i"]).float() + params["b_i"])
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * gi * u.float()


def _causal_conv(params, u, state=None):
    """Depthwise causal conv, width 4. u (b, s, r); state (b, 3, r) or None.
    -> (out (b, s, r), the last 3 inputs as the next state)."""
    b, s, r = u.shape
    pad = (state if state is not None
           else torch.zeros((b, _CONV_W - 1, r), dtype=u.dtype,
                            device=u.device))
    up = torch.cat([pad.to(u.dtype), u], dim=1)
    out = up[:, 0:s] * params["conv_w"][0]
    for i in range(1, _CONV_W):
        out = out + up[:, i:i + s] * params["conv_w"][i]
    return out + params["conv_b"], up[:, -(_CONV_W - 1):]


def _scan(a, x):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + x_t`` (h_{-1} = 0) along
    axis 1: Hillis-Steele, combining each element with the one ``shift``
    before it for shift = 1, 2, 4, ..."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        x = torch.cat([x[:, :shift], a[:, shift:] * x[:, :-shift]
                       + x[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return x


def rglru_block(params, x, h0=None, conv0=None, return_state: bool = False,
                chunk: int = 1024):
    """x (b, s, d) -> (b, s, d) [, (h_last (b, r) f32, conv state (b, 3, r))].

    ``h0`` (b, r) f32 and ``conv0`` (b, 3, r) continue a sequence (chunked
    prefill).  The recurrence runs in chunks of ``chunk`` with the state
    folded into each chunk's first element; a sequence that ``chunk`` does
    not divide runs as one chunk, as in the reference.
    """
    dt = x.dtype
    b, s, _ = x.shape
    rec = torch.matmul(x, params["w_rec_in"])
    gate = F.gelu(torch.matmul(x, params["w_gate_in"]), approximate="tanh")
    rec, conv_state = _causal_conv(params, rec, conv0)
    log_a, x_in = _gates(params, rec)                 # (b, s, r) f32
    a = torch.exp(log_a)
    r = a.shape[-1]

    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    h_prev = (h0 if h0 is not None
              else torch.zeros((b, r), dtype=torch.float32, device=x.device))
    hs = []
    for lo in range(0, s, chunk):
        a_i, x_i = a[:, lo:lo + chunk], x_in[:, lo:lo + chunk]
        x_i = torch.cat([(x_i[:, 0] + a_i[:, 0] * h_prev)[:, None],
                         x_i[:, 1:]], dim=1)          # fold the carried state
        h = _scan(a_i, x_i)
        h_prev = h[:, -1]
        hs.append(h)
    h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    out = torch.matmul(h.to(dt) * gate, params["w_out"])
    if return_state:
        return out, (h_prev, conv_state)
    return out


def rglru_decode_step(params, x, h, conv_state):
    """One token. x (b, 1, d); h (b, r) f32; conv_state (b, 3, r).
    -> (y (b, 1, d), new h, new conv state)."""
    dt = x.dtype
    rec = torch.matmul(x, params["w_rec_in"])
    gate = F.gelu(torch.matmul(x, params["w_gate_in"]), approximate="tanh")
    rec, conv_state = _causal_conv(params, rec, conv_state)
    log_a, x_in = _gates(params, rec)
    h = torch.exp(log_a[:, 0]) * h + x_in[:, 0]
    y = h[:, None].to(dt) * gate
    return torch.matmul(y, params["w_out"]), h, conv_state


def state_shapes(cfg: ModelConfig, batch: int):
    """Shapes of a layer's decode state: h (b, r), kept f32, and the conv
    taps (b, 3, r), kept in the params' dtype (:func:`init_state`)."""
    r = cfg.lru_dim or cfg.d_model
    return (batch, r), (batch, _CONV_W - 1, r)


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda"):
    """A layer's zero decode state on ``device``: h (b, r) in f32 and the
    conv taps (b, 3, r) in ``dtype``."""
    dev = resolve_device(device)
    h_shape, conv_shape = state_shapes(cfg, batch)
    return (torch.zeros(h_shape, dtype=torch.float32, device=dev),
            torch.zeros(conv_shape, dtype=dtype, device=dev))

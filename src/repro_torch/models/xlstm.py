"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

Counterpart of ``repro/models/xlstm.py``, plain PyTorch as the reference is
plain ``jnp`` (it has no Pallas kernel here).

* mLSTM has no hidden-to-hidden recurrence, so it runs in the *chunkwise*
  form: a Python loop over chunks (the reference's ``lax.scan``), quadratic
  only within a chunk, the (hd x hd) matrix state carried from chunk to
  chunk, with the paper's max-state stabilisation of the exponential gates.
  :func:`mlstm_decode_step` is the sequential step (decode, and the oracle
  :func:`mlstm_sequential`).
* sLSTM has a true recurrence (block-diagonal per-head R) and runs as a
  loop over the sequence.

The states start at ``m = -1e30`` and the causal gap within a chunk is
filled with ``-inf``, as in the reference, so ``exp`` gives exactly 0 there
(and a zero gradient, never NaN).  The gate biases ``bi``, ``bf`` and
``b_in`` and every state stay f32 whatever the param dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

_M0 = -1e30     # the stabiliser's start: exp(m0 - m) is exactly 0

# ---------------------------------------------------------------------------
# mLSTM


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (b, nh, hd, hd) f32
    n: torch.Tensor   # (b, nh, hd) f32
    m: torch.Tensor   # (b, nh) f32


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, nh, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": dense_init(gen, d, nh * hd, dtype, device),
        "wk": dense_init(gen, d, nh * hd, dtype, device),
        "wv": dense_init(gen, d, nh * hd, dtype, device),
        "wi": dense_init(gen, d, nh, dtype, device),
        "bi": torch.zeros((nh,), **f32),
        "wf": dense_init(gen, d, nh, dtype, device),
        "bf": torch.full((nh,), 3.0, **f32),   # forget-gate bias > 0
        "w_ogate": dense_init(gen, d, nh * hd, dtype, device),
        "w_out": dense_init(gen, nh * hd, d, dtype, device),
    }


def mlstm_state_shapes(cfg: ModelConfig, batch: int):
    """Shapes of (c, n, m) for ``batch`` rows."""
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    return (batch, nh, hd, hd), (batch, nh, hd), (batch, nh)


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    c, n, m = mlstm_state_shapes(cfg, batch)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(torch.zeros(c, **f32), torch.zeros(n, **f32),
                      torch.full(m, _M0, **f32))


def _mlstm_qkvif(params, x, cfg: ModelConfig):
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q = torch.matmul(x, params["wq"]).reshape(b, s, nh, hd)
    k = torch.matmul(x, params["wk"]).reshape(b, s, nh, hd) * (hd ** -0.5)
    v = torch.matmul(x, params["wv"]).reshape(b, s, nh, hd)
    i = torch.matmul(x, params["wi"]).float() + params["bi"]
    lf = F.logsigmoid(torch.matmul(x, params["wf"]).float() + params["bf"])
    return q, k, v, i, lf


def _mlstm_chunk(qx, kx, vx, ix, lfx, C, N, M):
    """One chunk (b, t, ...) from state (C, N, M) -> (h (b, t, nh, hd) f32,
    the state at the chunk's end)."""
    t = qx.shape[1]
    bcs = torch.cumsum(lfx, dim=1)                        # (b, t, nh)
    m_inter = bcs + M[:, None]                            # (b, t, nh)
    # intra-chunk decay of key s at query t: b_t - b_s + i_s for s <= t
    gap = bcs[:, :, None] - bcs[:, None] + ix[:, None]    # (b, t, s, nh)
    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=qx.device))
    gap = torch.where(tri[None, :, :, None], gap, -torch.inf)
    m_intra = gap.amax(dim=2)                             # (b, t, nh)
    m_t = torch.maximum(m_inter, m_intra)
    inter = torch.exp(m_inter - m_t)                      # (b, t, nh)
    decay = torch.exp(gap - m_t[:, :, None])              # (b, t, s, nh)
    qf, kf, vf = qx.float(), kx.float(), vx.float()
    sc = torch.einsum("bthd,bshd->btsh", qf, kf) * decay
    num = (torch.einsum("btsh,bshd->bthd", sc, vf)
           + inter[..., None] * torch.einsum("bthd,bhde->bthe", qf, C))
    den = (sc.sum(dim=2)
           + inter * torch.einsum("bthd,bhd->bth", qf, N))
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the state at the chunk's end
    B = bcs[:, -1]                                        # (b, nh)
    last = gap[:, -1]
    m_new = torch.maximum(B + M, torch.where(torch.isfinite(last), last,
                                             -torch.inf).amax(dim=1))
    kdec = torch.exp(B[:, None] - bcs + ix - m_new[:, None])   # (b, s, nh)
    carry = torch.exp(B + M - m_new)
    C_new = (carry[:, :, None, None] * C
             + torch.einsum("bsh,bshd,bshe->bhde", kdec, kf, vf))
    N_new = carry[:, :, None] * N + torch.einsum("bsh,bshd->bhd", kdec, kf)
    return h, (C_new, N_new, m_new)


def mlstm_chunked(params, x, cfg: ModelConfig,
                  state: Optional[MLSTMState] = None, chunk: int = 256,
                  return_state: bool = False):
    """x (b, s, d) -> (b, s, d): the chunk-parallel stabilised mLSTM.
    ``s`` must be a multiple of ``min(chunk, s)``."""
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v, ig, lf = _mlstm_qkvif(params, x, cfg)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    if state is None:
        state = mlstm_init_state(cfg, b, x.device)
    C, N, M = state
    hs = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        h, (C, N, M) = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], ig[:, sl],
                                    lf[:, sl], C, N, M)
        hs.append(h)
    h = torch.cat(hs, dim=1).to(x.dtype)
    og = torch.sigmoid(torch.matmul(x, params["w_ogate"])).reshape(b, s, nh,
                                                                    hd)
    out = torch.matmul((h * og).reshape(b, s, nh * hd), params["w_out"])
    if return_state:
        return out, MLSTMState(C, N, M)
    return out


def mlstm_decode_step(params, x, cfg: ModelConfig, state: MLSTMState):
    """x (b, 1, d) -> (y (b, 1, d), new state): the sequential step."""
    b = x.shape[0]
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v, ig, lf = _mlstm_qkvif(params, x, cfg)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    ig, lf = ig[:, 0], lf[:, 0]                           # (b, nh)
    C, N, M = state
    m_new = torch.maximum(lf + M, ig)
    a = torch.exp(lf + M - m_new)[..., None]
    bb = torch.exp(ig - m_new)[..., None]
    C = a[..., None] * C + bb[..., None] * torch.einsum("bhd,bhe->bhde", k, v)
    N = a * N + bb * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, N)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    og = torch.sigmoid(torch.matmul(x[:, 0], params["w_ogate"])).reshape(
        b, nh, hd)
    y = torch.matmul((h.to(x.dtype) * og).reshape(b, nh * hd),
                     params["w_out"])
    return y[:, None], MLSTMState(C, N, m_new)


def mlstm_sequential(params, x, cfg: ModelConfig,
                     state: Optional[MLSTMState] = None):
    """Step-by-step oracle of :func:`mlstm_chunked`."""
    if state is None:
        state = mlstm_init_state(cfg, x.shape[0], x.device)
    ys = []
    for t in range(x.shape[1]):
        y, state = mlstm_decode_step(params, x[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


# ---------------------------------------------------------------------------
# sLSTM


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (b, nh, hd) f32
    n: torch.Tensor   # (b, nh, hd) f32
    h: torch.Tensor   # (b, nh, hd) f32
    m: torch.Tensor   # (b, nh, hd) f32


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, nh, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    w_in = dense_init(gen, d, 4 * nh * hd, dtype, device)
    r = torch.randn((nh, hd, 4 * hd), generator=gen, **f32) * hd ** -0.5
    return {
        # input projections of z, i, f, o stacked: d -> 4 * nh * hd
        "w_in": w_in,
        "b_in": torch.cat([torch.zeros((nh * hd,), **f32),       # z
                           torch.zeros((nh * hd,), **f32),       # i
                           torch.full((nh * hd,), 3.0, **f32),   # f bias > 0
                           torch.zeros((nh * hd,), **f32)]),     # o
        # block-diagonal recurrent weights per head: (nh, hd, 4 * hd)
        "r": r.to(dtype),
        "w_out": dense_init(gen, d, d, dtype, device),
    }


def slstm_state_shape(cfg: ModelConfig, batch: int):
    """Shape of each of (c, n, h, m) for ``batch`` rows."""
    return (batch, cfg.num_heads, cfg.resolved_head_dim)


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    sh = slstm_state_shape(cfg, batch)
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros(sh, **f32)
    return SLSTMState(z, z, z, torch.full(sh, _M0, **f32))


def _slstm_cell(params, u_t, state: SLSTMState, nh: int, hd: int):
    """u_t (b, 4 * nh * hd), the input's pre-activation -> (h (b, nh, hd),
    new state)."""
    c, n, h, m = state
    rec = torch.einsum("bhd,hde->bhe", h.to(params["r"].dtype), params["r"])
    pre = (u_t.reshape(-1, nh, 4 * hd).float() + rec.float()
           + params["b_in"].reshape(nh, 4 * hd))
    z, i, f, o = torch.split(pre, hd, dim=-1)           # (b, nh, hd) each
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    lf = F.logsigmoid(f)
    m_new = torch.maximum(lf + m, i)
    a = torch.exp(lf + m - m_new)
    bb = torch.exp(i - m_new)
    c = a * c + bb * z
    n = a * n + bb
    h_new = o * (c / torch.clamp(n, min=1e-12))
    return h_new, SLSTMState(c, n, h_new, m_new)


def slstm_block(params, x, cfg: ModelConfig,
                state: Optional[SLSTMState] = None,
                return_state: bool = False):
    """x (b, s, d) -> (b, s, d): a loop over the sequence."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    u = torch.matmul(x, params["w_in"])                 # (b, s, 4 * nh * hd)
    if state is None:
        state = slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        h, state = _slstm_cell(params, u[:, t], state, nh, hd)
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(b, s, nh * hd).to(x.dtype)
    out = torch.matmul(hs, params["w_out"])
    if return_state:
        return out, state
    return out


def slstm_decode_step(params, x, cfg: ModelConfig, state: SLSTMState):
    b = x.shape[0]
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    u = torch.matmul(x[:, 0], params["w_in"])
    h, state = _slstm_cell(params, u, state, nh, hd)
    out = torch.matmul(h.reshape(b, nh * hd).to(x.dtype), params["w_out"])
    return out[:, None], state

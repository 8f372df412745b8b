"""Core layers: norms, rotary embeddings (RoPE / M-RoPE), projections, gated
MLP.

Counterpart of ``repro/models/layers.py``.  Params are
plain dicts of tensors with the reference's names and layouts (``(d_in,
d_out)`` weights), so converted reference params drop straight in.  Init
functions take an explicit :class:`torch.Generator`; the big projections stay
``torch.matmul``, as the reference left them to XLA.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor
from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# products


def dense(x, w):
    """x (..., d_in) @ w (d_in, d_out).  For a ``DTensor`` x of 3 or more
    dims the product folds the leading dims into rows, which DTensor (torch
    2.11) cannot do when a dim past the first is sharded: such dims are
    gathered first (the sequence, between blocks), and the output's
    gradient is pinned to the output's layout for the fold's backward."""
    if not is_dtensor(x) or x.ndim < 3:
        return torch.matmul(x, w)
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
          for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    out = torch.matmul(x, w)
    return out.redistribute(out.device_mesh, out.placements)


def beside(x, *ts):
    """Plain tensors ``ts`` made to meet ``x``: replicated DTensors on its
    mesh where ``x`` is a ``DTensor`` (DTensor refuses mixed operands, in
    the backward too), as they are otherwise.  None stays None."""
    if not is_dtensor(x):
        return ts
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return tuple(t if t is None or is_dtensor(t) else
                 DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
                 for t in ts)


def on_mesh(x):
    """Where ``x`` is a ``DTensor``, a context in which plain tensors meet
    DTensors as replicated on its mesh (DTensor's ``implicit_replication``:
    the serving path's host-made positions, frequencies and indices, the
    same on every rank); otherwise a context that does nothing."""
    if not is_dtensor(x):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def shard_index(mesh, placements, dim: int) -> int:
    """This rank's index among the shards of tensor dim ``dim`` over the
    mesh dims that split it (``placements``, one a mesh dim), the earlier
    mesh dim outermost, as DTensor orders them; 0 where none does."""
    idx = 0
    for coord, n, p in zip(mesh.get_coordinate(), mesh.shape, placements):
        if p.is_shard(dim):
            idx = idx * n + coord
    return idx


def from_shards(local, mesh, placements, grad_placements):
    """``DTensor.from_local(local, mesh, placements)`` whose backward hands
    ``local`` the gradient placed as ``grad_placements`` (torch 2.11's
    ``from_local`` takes no such argument).  A partial result of a local
    computation needs it: every rank's share then gets the whole
    gradient, where the default would split it over the ranks."""
    return _FromShards.apply(local, mesh, tuple(placements),
                             tuple(grad_placements))


class _FromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements, grad_placements):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return DTensor.from_local(local, mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return (grad.redistribute(ctx.mesh, ctx.grad_placements).to_local(),
                None, None, None)


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


def mrope_angles(positions_3d, head_dim: int, sections, theta: float):
    """Qwen2-VL's multimodal RoPE: positions_3d (3, b, s), the temporal,
    height and width streams -> cos/sin (b, s, head_dim//2).  The frequency
    slots are split into ``sections`` (summing to head_dim//2); each section
    takes its angle from its own stream."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"{half}")
    freq = float(theta) ** (-torch.arange(0, half, dtype=torch.float32,
                                          device=positions_3d.device) / half)
    ang = positions_3d[..., None].float() * freq          # (3, b, s, half)
    # built from Python ints: its length is static, as the reference's
    # ``total_repeat_length=half`` makes it (a fake tensor cannot size a
    # data-dependent repeat)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=ang.device)  # (half,)
    one_hot = F.one_hot(sec_id, 3).float()                # (half, 3)
    ang = torch.einsum("pbsh,hp->bsh", ang, one_hot)
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


def mlp(params, x, ctx=None):
    g = dense(x, params["w_gate"])
    u = dense(x, params["w_up"])
    h = F.silu(g) * u
    if ctx is not None:
        # pin the FFN hidden to (batch, seq-local, ff@tp) on a mesh: keeps
        # the weight gradients' products sharded on d_ff
        h = ctx.constrain(h, (ctx.dp_axes, None, ctx.tp_axis))
    return dense(h, params["w_down"])


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
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, params["wq"])
    k = dense(x, params["wk"])
    v = dense(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return (split_heads(q, h, hd), split_heads(k, kv, hd),
            split_heads(v, kv, hd))


def split_heads(t, n: int, hd: int):
    """(b, s, n * hd) -> (b, s, n, hd).  A ``DTensor`` whose last dim is
    sharded over a mesh dim that does not divide the n heads is gathered on
    that mesh dim first (DTensor cannot split an uneven shard)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        sizes = t.device_mesh.shape
        pl = [Replicate() if p.is_shard(t.ndim - 1) and n % sizes[i] else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], n, hd)


def out_proj(params, attn_out):
    b, s, h, hd = attn_out.shape
    flat = attn_out.reshape(b, s, h * hd)
    if is_dtensor(flat):
        # pin the merged heads' gradient to their own layout: the backward
        # of the merge cannot split a dim sharded unevenly over the heads
        flat = flat.redistribute(flat.device_mesh, flat.placements)
    return dense(flat, params["wo"])

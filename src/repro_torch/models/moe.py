"""Mixture-of-Experts FFN: GShard-style grouped dispatch with capacity.

Counterpart of ``repro/models/moe.py``.  Tokens are reshaped into groups of
``group_size``; a one-hot dispatch tensor (b, groups, S, E, C) routes each
token to its top-k experts subject to a per-group, per-expert capacity
``C = group_size * top_k * capacity_factor / E`` (at least 4).  Tokens past
an expert's capacity are dropped for that expert (GShard semantics).  The
capacity is taken from ``group_size`` even when a call's group is shorter
(a decode step's group is one token), as the reference takes it: the
expert products then run over E x C rows whatever the call's length.

The reference pins the expert tensors' shardings on a mesh; the port has no
mesh and drops those pins.  The router runs in f32; the expert products in
the activations' dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             device) -> Dict[str, torch.Tensor]:
    moe = cfg.moe
    d, ff, E = cfg.d_model, cfg.d_ff, moe.num_experts

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        return (w * d_in ** -0.5).to(dtype)

    p = {
        # the router stays f32 whatever the params' dtype
        "router": torch.randn((d, E), generator=gen, dtype=torch.float32,
                              device=device) * d ** -0.5,
        "we_gate": experts(d, ff),
        "we_up": experts(d, ff),
        "we_down": experts(ff, d),
    }
    if moe.num_shared_experts:
        p["shared"] = L.init_mlp(gen, d, ff * moe.num_shared_experts, dtype,
                                 device)
    return p


def capacity(moe: MoEConfig) -> int:
    c = int(moe.group_size * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(c, 4)


def moe_ffn(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y (b, s, d), aux loss scalar f32).

    The aux loss is the GShard/Switch load-balance loss ``E * sum_e f_e *
    p_e``: f_e the share of tokens whose first choice is expert e, p_e the
    mean router probability of e.
    """
    moe = cfg.moe
    b, s, d = x.shape
    E, K = moe.num_experts, moe.top_k
    S = min(moe.group_size, s)
    if s % S:
        raise ValueError(f"sequence {s} is not a multiple of the MoE group "
                         f"{S}")
    G = s // S
    C = capacity(moe)
    xg = x.reshape(b, G, S, d)

    # f32 router logits from the activations' dtype (exact products, f32 sums)
    logits = torch.matmul(xg.float(), params["router"].to(x.dtype).float())
    probs = torch.softmax(logits, dim=-1)                        # (b,G,S,E)

    # top-k, then sequential-priority capacity: an expert's position counter
    # carries over from one priority level to the next
    gate_k, idx_k = torch.topk(probs, K, dim=-1)                 # (b,G,S,K)
    combine = torch.zeros((b, G, S, E, C), dtype=torch.float32,
                          device=x.device)
    fill = torch.zeros((b, G, E), dtype=torch.int64, device=x.device)
    for k in range(K):
        onehot_e = F.one_hot(idx_k[..., k], E)                   # (b,G,S,E)
        pos = torch.cumsum(onehot_e, dim=2) - 1 + fill[:, :, None, :]
        fill = fill + torch.sum(onehot_e, dim=2)
        keep = (pos < C) & (onehot_e > 0)
        onehot_c = F.one_hot(torch.clamp(pos, 0, C - 1), C).float()
        combine = combine + (gate_k[..., k][..., None, None]
                             * keep[..., None] * onehot_c)
    if K > 1:  # renormalise over the top-k gates (Mixtral)
        denom = torch.sum(gate_k, dim=-1)[..., None, None]
        combine = combine / torch.clamp(denom, min=1e-9)
    dispatch = (combine > 0).to(x.dtype)                         # (b,G,S,E,C)

    xin = torch.einsum("bgsec,bgsd->begcd", dispatch, xg)        # (b,E,G,C,d)
    h = F.silu(torch.einsum("begcd,edf->begcf", xin, params["we_gate"]))
    h = h * torch.einsum("begcd,edf->begcf", xin, params["we_up"])
    out = torch.einsum("begcf,efd->begcd", h, params["we_down"])
    y = torch.einsum("bgsec,begcd->bgsd", combine.to(x.dtype), out)
    y = y.reshape(b, s, d)

    if "shared" in params:
        y = y + L.mlp(params["shared"], x)

    frac_tokens = torch.mean(F.one_hot(idx_k[..., 0], E).float(),
                             dim=(0, 1, 2))
    frac_probs = torch.mean(probs, dim=(0, 1, 2))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux

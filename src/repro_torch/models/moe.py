"""Mixture-of-Experts FFN: GShard-style grouped dispatch with capacity.

Counterpart of ``repro/models/moe.py``.  Tokens are reshaped into groups of
``group_size``; a one-hot dispatch tensor (b, groups, S, E, C) routes each
token to its top-k experts subject to a per-group, per-expert capacity
``C = group_size * top_k * capacity_factor / E`` (at least 4).  Tokens past
an expert's capacity are dropped for that expert (GShard semantics).  A
call whose group is shorter than ``group_size`` (a decode step's group is
one token, a prompt's last chunk may be shorter) runs over
``min(C, S)`` capacity rows per group of S tokens: top-k picks distinct
experts, so an expert takes at most one row a token and no row at or past
S can be filled whatever the capacity factor.  The clamp changes no
routing, drop, gate or output of the reference's E x C layout; it only
leaves out rows that are always zero.

On a mesh (``DTensor`` activations) the expert tensors are pinned as the
reference pins them, and the routing runs on each rank's rows.  The router runs in
f32; the expert products in the activations' dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.obs import spans


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


def _route(xg, router, moe: MoEConfig, C: int):
    """Top-k routing with sequential-priority capacity, per (row, group):
    xg (b, G, S, d) -> (combine (b, G, S, E, C) f32, router probabilities
    (b, G, S, E), one-hot first choices (b, G, S, E) f32)."""
    E, K = moe.num_experts, moe.top_k
    b, G, S, _ = xg.shape
    # f32 router logits from the activations' dtype (exact products, f32 sums)
    logits = torch.matmul(xg.float(), router.to(xg.dtype).float())
    probs = torch.softmax(logits, dim=-1)                        # (b,G,S,E)

    # top-k, then sequential-priority capacity: an expert's position counter
    # carries over from one priority level to the next
    gate_k, idx_k = torch.topk(probs, K, dim=-1)                 # (b,G,S,K)
    combine = torch.zeros((b, G, S, E, C), dtype=torch.float32,
                          device=xg.device)
    fill = torch.zeros((b, G, E), dtype=torch.int64, device=xg.device)
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
    return combine, probs, F.one_hot(idx_k[..., 0], E).float()


def _route_local(xg, router, moe: MoEConfig, C: int):
    """:func:`_route` on each rank's rows of the ``DTensor`` ``xg`` (routing
    is per row, and DTensor has no strategy for its top-k and counters);
    the outputs carry ``xg``'s placements.  The router's gradient is
    partial over the mesh dims that shard the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = xg.device_mesh
    grad_r = [Partial() if p.is_shard() else Replicate()
              for p in xg.placements]
    outs = _route(xg.to_local(), router.to_local(grad_placements=grad_r),
                  moe, C)
    return tuple(DTensor.from_local(t, mesh, xg.placements) for t in outs)


def _experts(xg, dispatch, combine, wg, wu, wd):
    """The expert FFN of (b, G, S, d) rows: dispatch onto (b, E, G, C, d)
    capacity slots, the gated expert products, and the weighted combine
    back -> (b, G, S, d)."""
    xin = torch.einsum("bgsec,bgsd->begcd", dispatch, xg)        # (b,E,G,C,d)
    h = F.silu(torch.einsum("begcd,edf->begcf", xin, wg))
    h = h * torch.einsum("begcd,edf->begcf", xin, wu)
    out = torch.einsum("begcf,efd->begcd", h, wd)                # (b,E,G,C,d)
    return torch.einsum("bgsec,begcd->bgsd", combine.to(xg.dtype), out)


def _experts_sharded(xg, dispatch, combine, params, ctx, expert_parallel):
    """:func:`_experts` on a mesh, each rank on its rows and its part of the
    experts: the expert dim over ``tp_axis`` (expert parallelism: a rank
    takes the capacity slots of its experts) or each expert's d_ff over it
    (tensor-parallel experts), the weights' FSDP shards gathered.  The
    result is partial over ``tp_axis`` where it splits the experts (the
    combine sums the ranks' parts) and keeps the rows' placements
    elsewhere; each rank's gradient of it is whole."""
    from torch.distributed.tensor import Partial, Replicate
    mesh, tp = xg.device_mesh, ctx.tp_axis
    t = mesh.mesh_dim_names.index(tp) if tp in mesh.mesh_dim_names else -1
    if expert_parallel:
        up_ax, down_ax = (tp, None, None), (tp, None, None)
    else:
        up_ax, down_ax = (None, None, tp), (None, tp, None)
    ws = [ctx.constrain(params["we_gate"], up_ax),
          ctx.constrain(params["we_up"], up_ax),
          ctx.constrain(params["we_down"], down_ax)]
    split = t >= 0 and ws[0].placements[t].is_shard()
    # a weight's gradient is partial over the mesh dims that shard the rows;
    # the rows' gradients are partial over tp where the experts are split
    local = [w.to_local(grad_placements=[
        Partial() if p.is_shard() else w_p
        for p, w_p in zip(xg.placements, w.placements)]) for w in ws]
    part = [Partial() if i == t and split else p
            for i, p in enumerate(xg.placements)]
    xl = xg.to_local(grad_placements=part)
    dl, cl = dispatch.to_local(), combine.to_local(grad_placements=part)
    if expert_parallel and split:
        el = local[0].shape[0]
        e0 = mesh.get_local_rank(t) * el
        dl, cl = dl[..., e0:e0 + el, :], cl[..., e0:e0 + el, :]
    whole = [Replicate() if i == t else p for i, p in enumerate(xg.placements)]
    return L.from_shards(_experts(xl, dl, cl, *local), mesh, part, whole)


def moe_ffn(params, x, cfg: ModelConfig,
            ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y (b, s, d), aux loss scalar f32).

    The aux loss is the GShard/Switch load-balance loss ``E * sum_e f_e *
    p_e``: f_e the share of tokens whose first choice is expert e, p_e the
    mean router probability of e.  ``ctx`` (a ``RunCtx`` with a mesh) pins
    the expert tensors: expert-parallel (the expert dim over ``tp_axis``)
    when it divides E, tensor-parallel experts (d_ff over ``tp_axis``)
    otherwise, as ``dist/sharding.py`` places their weights.

    The call is the span ``repro.model.moe_ffn``; while spans are on it
    counts ``moe.assigned_rows``, ``moe.capacity_rows`` and
    ``moe.routed_rows`` over its rows (a rank's own on a mesh).
    """
    with spans.span("repro.model.moe_ffn"):
        return _moe_ffn(params, x, cfg, ctx)


def _count_rows(dispatch, top_k: int) -> None:
    """The spans' MoE counters of one call's (b, G, S, E, C) dispatch: the
    rows its tokens ask for, the capacity rows the experts run over, and
    the rows routed (the rest were dropped)."""
    local = dispatch.to_local() if is_dtensor(dispatch) else dispatch
    b, G, S, E, C = local.shape
    spans.count("moe.assigned_rows", b * G * S * top_k)
    spans.count("moe.capacity_rows", b * E * G * C)
    spans.count_on_device("moe.routed_rows", torch.count_nonzero(local))


def _moe_ffn(params, x, cfg: ModelConfig, ctx):
    moe = cfg.moe
    b, s, d = x.shape
    E = moe.num_experts
    S = min(moe.group_size, s)
    if s % S:
        raise ValueError(f"sequence {s} is not a multiple of the MoE group "
                         f"{S}")
    G = s // S
    # an expert takes at most one row a token: rows past S stay empty
    C = min(capacity(moe), S)
    if ctx is not None:
        # the groups split the sequence: rows whole on each rank
        x = ctx.constrain(x, (ctx.dp_axes, None, None))
    xg = x.reshape(b, G, S, d)

    if not is_dtensor(xg):
        combine, probs, first = _route(xg, params["router"], moe, C)
        dispatch = (combine > 0).to(x.dtype)                     # (b,G,S,E,C)
        y = _experts(xg, dispatch, combine, params["we_gate"],
                     params["we_up"], params["we_down"])
    else:
        # expert-parallel (E % tp == 0) vs tensor-parallel experts (d_ff
        # over tp); routing and experts on each rank's rows
        tp_size = dict(zip(xg.device_mesh.mesh_dim_names,
                           xg.device_mesh.shape)).get(ctx.tp_axis, 1)
        combine, probs, first = _route_local(xg, params["router"], moe, C)
        dispatch = (combine > 0).to(x.dtype)
        y = _experts_sharded(xg, dispatch, combine, params, ctx,
                             E % tp_size == 0)
    if spans.enabled():
        _count_rows(dispatch, moe.top_k)
    y = y.reshape(b, s, d)
    if is_dtensor(y):
        # pin the merged groups' gradient to their own layout: the backward
        # of the merge cannot split a sequence sharded over more ranks than
        # there are groups
        y = y.redistribute(y.device_mesh, y.placements)

    if "shared" in params:
        y = y + L.mlp(params["shared"], x)

    frac_tokens = torch.mean(first, dim=(0, 1, 2))
    frac_probs = torch.mean(probs, dim=(0, 1, 2))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux

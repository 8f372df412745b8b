"""Weighted gradient aggregation (paper Eqn 4a-c) + linear LR scaling.

Counterpart of ``repro/core/weighted_agg.py``.  Devices train on
rate-proportional batches b_i = clip(S_i, b_min, b_max) and gradients
combine with weights r_i = S_i / sum_j S_j.  ``weighted_aggregate`` is the
stacked-gradients form the trainer runs: one ``tensordot`` over the leading
device axis, leaf by leaf.  ``psum_weighted`` is the same sum across
processes, over a device mesh's axes (the reference's shard_map body).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad_and_value

from repro_torch.tree import leaves, tree_map


def clip_batch(rates, b_min: int, b_max: int):
    """b_i = clip(S_i, b_min, b_max)  (paper §IV)."""
    return torch.clamp(torch.as_tensor(rates), b_min, b_max)


def rate_weights(rates):
    """Eqn 4a: r_i = S_i / sum_j S_j (sums to 1), in f32."""
    rates = torch.as_tensor(rates).float()
    return rates / torch.clamp(torch.sum(rates), min=1e-9)


def weighted_aggregate(stacked_grads, rates, normalize: bool = True):
    """Eqn 4b over a leading device axis: g~ = sum_i r_i g_i.

    ``normalize=False`` uses ``rates`` as final combination weights verbatim:
    the relaxed-consistency trainer passes host-computed weights whose
    staleness damping must survive (a normalized single-participant commit
    would cancel its own damping factor).
    """
    w = rate_weights(rates) if normalize else torch.as_tensor(rates).float()
    return tree_map(
        lambda g: torch.tensordot(w.to(device=g.device, dtype=g.dtype), g,
                                  dims=([0], [0])), stacked_grads)


def skew_corrected_rates(rates, divergence, floor: float = 0.05):
    """Skew-corrected weighting (non-IID streams): effective rate
    ``r_i * c_i`` with ``c_i = clip(1 - TV_i, floor, 1)``, device i's label
    coverage.  IID devices (TV = 0) are untouched, so the mode degenerates
    to Eqn 4a exactly on IID streams.

    Host-side numpy on purpose, as in the reference: weights are assembled
    on the host and stay float64 until the final cast.
    """
    cov = np.clip(1.0 - np.asarray(divergence, np.float64), float(floor), 1.0)
    return np.asarray(rates, np.float64) * cov


def linear_scaled_lr(base_lr: float, rates, base_global_batch: float):
    """eta_scaled = (sum_j S_j / B) * eta  (paper's linear-scaling rule), as
    an f32 tensor on the rates' device."""
    gamma = torch.sum(torch.as_tensor(rates).float()) / base_global_batch
    return base_lr * gamma


def psum_weighted(grad, rate, mesh, axes: Sequence[str]):
    """Eqn 4b across processes: the weighted all-reduce of this rank's
    gradient over ``mesh``'s ``axes`` (a ``DeviceMesh``).

    grad: this rank's gradient pytree; rate: its scalar streaming rate.
    The rates are all-reduced over each axis's group in turn into their
    total, this rank's weight is ``w = rate / max(total, 1e-9)``, and each
    leaf ``g * w`` is all-reduced over the same groups.  Returns
    ``(g~, total)``, as the reference's code does: its docstring calls the
    second value gamma = sum(rates) / n, but what it returns is the sum of
    the rates, and so does this.  The all-reduces are in place on fresh
    tensors and carry no autograd: this aggregates gradients.
    """
    dev = leaves(grad)[0].device
    rate = torch.as_tensor(rate, dtype=torch.float32, device=dev)
    total = rate.clone()
    groups = [mesh.get_group(ax) for ax in axes]
    for group in groups:
        dist.all_reduce(total, group=group)
    w = rate / torch.clamp(total, min=1e-9)

    def agg(g):
        y = g * w.to(g.dtype)
        for group in groups:
            dist.all_reduce(y, group=group)
        return y

    return tree_map(agg, grad), total


def masked_mean_grads(loss_fn, params, batch, mask):
    """Per-device gradient over the *valid* slots of a fixed-size batch:
    ``mask`` (b,) marks which of the b_max slots hold real streamed samples,
    and the loss averages over valid slots only.  Returns (loss, grads)."""
    def masked_loss(p):
        per = loss_fn(p, batch)          # (b,) per-sample losses
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)

    grads, loss = grad_and_value(masked_loss)(params)
    return loss, grads

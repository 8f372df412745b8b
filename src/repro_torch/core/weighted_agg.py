"""Weighted gradient aggregation (paper Eqn 4a-c) + linear LR scaling.

Counterpart of ``repro/core/weighted_agg.py``.  Devices train on
rate-proportional batches b_i = clip(S_i, b_min, b_max) and gradients
combine with weights r_i = S_i / sum_j S_j.  ``weighted_aggregate`` is the
stacked-gradients form the trainer runs: one ``tensordot`` over the leading
device axis, leaf by leaf.  The reference's shard_map form,
``psum_weighted``, is a collective body no trainer path calls; it waits for
the port's distribution slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.tree import tree_map


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


def masked_mean_grads(loss_fn, params, batch, mask):
    """Per-device gradient over the *valid* slots of a fixed-size batch:
    ``mask`` (b,) marks which of the b_max slots hold real streamed samples,
    and the loss averages over valid slots only.  Returns (loss, grads)."""
    def masked_loss(p):
        per = loss_fn(p, batch)          # (b,) per-sample losses
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)

    grads, loss = grad_and_value(masked_loss)(params)
    return loss, grads

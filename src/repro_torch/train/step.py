"""Train-step factory: loss, gradients (with microbatch accumulation) and
the optimizer update; the loss and eval-step factories beside it.

Counterpart of ``repro/train/step.py``.  ScaDLES' weighted aggregation
(Eqn 4) enters as per-sample loss weights: every sample carries
``w_s = r_dev(s) / b_dev(s)`` (``sample_weights``, summing to 1 over the
global batch), so the gradient of the weighted loss is the paper's weighted
aggregate.  Where the reference differentiates with ``jax.value_and_grad``
and accumulates microbatches in a ``lax.scan``, the port takes each
gradient with ``torch.autograd.grad`` and accumulates in a Python loop.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch import is_dtensor
from repro_torch.models.transformer import RunCtx, forward_hidden, lm_loss
from repro_torch.obs import spans
from repro_torch.tree import leaves, tree_map, unflatten

MOE_AUX_WEIGHT = 0.01
# batch inputs passed through to forward_hidden (whisper, qwen2-vl)
EXTRA_INPUTS = ("audio_feats", "patch_embeds", "mrope_positions")


def make_loss_fn(cfg: ModelConfig, ctx: RunCtx, sum_form: bool = False):
    """-> ``loss_fn(params, batch) -> (total, {"loss", "aux"})``.

    ``sum_form``: return the weighted SUM of per-token nll (weights are
    globally normalised by the data pipeline), so microbatch gradients
    accumulate by addition without renormalisation.
    """
    def loss_fn(params, batch: Dict[str, Any]):
        extras = {k: batch[k] for k in EXTRA_INPUTS if k in batch}
        h, aux = forward_hidden(params, batch["tokens"], cfg, ctx, **extras)
        mask = batch.get("loss_mask")
        w = batch.get("sample_weights")   # (b,) ScaDLES rate weights, sum=1
        if w is not None:
            base = (torch.ones_like(batch["labels"], dtype=torch.float32)
                    if mask is None else mask)
            if sum_form:
                # per-token weight w_i / (#valid tokens of i): the weighted
                # SUM over any microbatch partition equals the full-batch
                # weighted mean (sum over all tokens is exactly 1)
                per_tok = base / torch.clamp(
                    torch.sum(base, dim=1, keepdim=True), min=1.0)
                mask = per_tok * w[:, None]
            else:
                mask = base * w[:, None]
        loss = lm_loss(params, h, batch["labels"], cfg, ctx, loss_mask=mask,
                       normalize=not sum_form)
        return loss + MOE_AUX_WEIGHT * aux, {"loss": loss, "aux": aux}

    return loss_fn


def make_eval_step(cfg: ModelConfig, ctx: RunCtx):
    loss_fn = make_loss_fn(cfg, ctx)

    def eval_step(params, batch):
        with torch.no_grad():
            _, m = loss_fn(params, batch)
        return m

    return eval_step


def value_and_grad(loss_fn, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, Any], List[torch.Tensor]]:
    """``loss_fn(params, batch)`` -> (total, metrics, gradients), the
    gradients in :func:`repro_torch.tree.leaves` order (zeros for a leaf the
    loss does not reach), everything detached: no graph outlives the call.
    The loss is the span ``repro.train.forward``, the gradient and its
    zero fill ``repro.train.backward`` (with remat's recomputed forward)."""
    flat_p = leaves(params)
    live = [p.detach().requires_grad_() for p in flat_p]
    with spans.span("repro.train.forward"):
        total, metrics = loss_fn(unflatten(params, live), batch)
    if is_dtensor(total):
        # the backward seeds a replicated 1, never a partial one
        metrics = {k: _replicated(v) if is_dtensor(v) else v
                   for k, v in metrics.items()}
        total = _replicated(total)
    with spans.span("repro.train.backward"):
        grads = torch.autograd.grad(total, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, flat_p)]
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _replicated(x):
    """A ``DTensor`` replicated over its mesh (a partial sum reduced)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _pinned(x, placements):
    """``x`` (a ``DTensor``) redistributed to ``placements`` on its mesh;
    a plain tensor as it is."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _check_mirrors(params, shardings) -> None:
    """Raise ``ValueError`` unless ``shardings`` has ``params``' structure
    with one ``NamedSharding`` (``dist.sharding.named``) a leaf, whose spec
    has an entry per dim of its param."""
    flat_s = leaves(shardings)
    same_shape = (tree_map(lambda _: None, shardings)
                  == tree_map(lambda _: None, params))
    if (not same_shape
            or not all(hasattr(s, "placements") and hasattr(s, "spec")
                       for s in flat_s)
            or any(len(s.spec) != p.ndim
                   for s, p in zip(flat_s, leaves(params)))):
        raise ValueError("grad_shardings must mirror the params: one "
                         "NamedSharding (dist.sharding.named) per leaf")


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(b, ...) -> (n_micro, b / n_micro, ...), the reference's rule.

    An array of ``ndim >= 2`` whose leading axis is 3 is taken for M-RoPE
    positions (3, b, s) and split on axis 1.  Kept as the reference has it:
    a global batch of exactly 3 rows is therefore split along the sequence
    (tokens (3, s) -> (n_micro, 3, s / n_micro)), while the (3,) weights
    split by row.

    A ``DTensor`` whose batch dim (0, or 1 for (3, b, s) positions) is
    sharded splits each rank's local rows, (b_local) -> (n_micro, b_local /
    n_micro) with the shard on the second dim, so microbatch i takes rows
    from every rank.  That is a different partition of the same rows from the
    reference's (where XLA reshards whatever ``n_micro`` is), with the same
    accumulated sum-form gradient; a global split would need ``n_micro`` to
    be a multiple of the data ranks.  ``b_local % n_micro`` raises
    ``ValueError``."""
    if is_dtensor(x):
        batch_dim = 1 if x.ndim >= 3 and x.shape[0] == 3 else 0
        if any(p.is_shard(batch_dim) for p in x.placements):
            return _split_local_rows(x, n_micro, batch_dim)
    if x.ndim >= 2 and x.shape[0] == 3:
        return x.reshape(3, n_micro, x.shape[1] // n_micro,
                         *x.shape[2:]).transpose(0, 1)
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


def _split_local_rows(x, n_micro: int, batch_dim: int):
    """:func:`split_microbatches` of a ``DTensor`` sharded on ``batch_dim``
    (0, or 1 under the 3-row rule), on each rank's local rows: every dim
    moves one place right, the batch's shard onto its local part."""
    from torch.distributed.tensor import DTensor, Shard
    local = x.to_local()
    b_local = local.shape[batch_dim]
    if b_local % n_micro:
        raise ValueError(f"each rank holds {b_local} rows of the batch, "
                         f"which n_micro {n_micro} does not divide")
    shape = local.shape
    local = local.reshape(*shape[:batch_dim], n_micro, b_local // n_micro,
                          *shape[batch_dim + 1:])
    if batch_dim:
        local = local.transpose(0, 1)
    places = [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements]
    return DTensor.from_local(local, x.device_mesh, places, run_check=False)


def make_train_step(cfg: ModelConfig, ctx: RunCtx, opt_update: Callable,
                    lr_schedule: Callable, n_micro: int = 1,
                    grad_shardings=None, grad_wire_bf16: bool = False):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``.

    ``n_micro == 1``: the gradient of the mean-form loss; the metrics are
    ``make_loss_fn``'s.  ``n_micro > 1``: gradient accumulation over
    microbatches, each the sum-form gradient at the same params, added into
    f32 zeros; needs ``sample_weights`` in the batch (uniform weights
    reproduce conventional DDL); the metrics are ``{"loss": total, "aux":
    0}``.  ``grad_wire_bf16`` rounds each microbatch gradient to bf16 (round
    to nearest even, as XLA's convert) before the f32 add.  Every step adds
    ``total``, ``grad_norm`` (the f32 norm of the accumulated gradient
    before the update) and ``lr = lr_schedule(step)`` to the metrics.

    On a mesh (``ctx.mesh``; params, state and batch ``DTensor``s from
    ``dist.sharding.distribute``) each microbatch keeps its leaves'
    placements, and ``grad_shardings`` (``dist.sharding.named`` of the
    param specs, mirroring the params) pins the f32 accumulator ZeRO-2
    fashion: it is created with those placements and brought back to them
    after each microbatch, so a partial gradient is reduce-scattered into
    it instead of all-reduced whole.  A tree that does not mirror the
    params raises ``ValueError``.
    """
    loss_mean = make_loss_fn(cfg, ctx, sum_form=False)
    loss_sum = make_loss_fn(cfg, ctx, sum_form=True)

    def finish(params, opt_state, grads, total, metrics, step):
        lr = lr_schedule(step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        params, opt_state = opt_update(unflatten(params, grads), opt_state,
                                       params, lr)
        metrics = dict(metrics, total=total, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    def train_step(params, opt_state, batch, step):
        if grad_shardings is not None:
            _check_mirrors(params, grad_shardings)
        if n_micro == 1:
            total, metrics, grads = value_and_grad(loss_mean, params, batch)
            return finish(params, opt_state, grads, total, metrics, step)

        if "sample_weights" not in batch:
            raise ValueError("microbatching needs sample weights")
        micro = {k: split_microbatches(v, n_micro) for k, v in batch.items()}
        flat_p = leaves(params)
        if grad_shardings is None:
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in flat_p]
        else:
            places = [s.placements for s in leaves(grad_shardings)]
            grads = [_pinned(torch.zeros_like(p, dtype=torch.float32), pl)
                     for p, pl in zip(flat_p, places)]
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        for i in range(n_micro):
            mb = {k: _pinned(v[i], batch[k].placements) if is_dtensor(v)
                  else v[i] for k, v in micro.items()}
            t, _, g = value_and_grad(loss_sum, params, mb)
            for acc, gi in zip(grads, g):
                if grad_wire_bf16:
                    gi = gi.to(torch.bfloat16)
                acc.add_(_pinned(gi.float(), acc.placements)
                         if is_dtensor(acc) else gi.float())
            total = total + t
        return finish(params, opt_state, grads, total,
                      {"loss": total, "aux": torch.zeros_like(total)}, step)

    return train_step

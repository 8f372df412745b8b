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
from repro_torch.models.transformer import RunCtx, forward_hidden, lm_loss
from repro_torch.tree import leaves, unflatten

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
            base = (torch.ones(batch["labels"].shape, dtype=torch.float32,
                               device=h.device) if mask is None else mask)
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
    loss does not reach), everything detached: no graph outlives the call."""
    flat_p = leaves(params)
    live = [p.detach().requires_grad_() for p in flat_p]
    total, metrics = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat_p)]
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(b, ...) -> (n_micro, b / n_micro, ...), the reference's rule.

    An array of ``ndim >= 2`` whose leading axis is 3 is taken for M-RoPE
    positions (3, b, s) and split on axis 1.  Kept as the reference has it:
    a global batch of exactly 3 rows is therefore split along the sequence
    (tokens (3, s) -> (n_micro, 3, s / n_micro)), while the (3,) weights
    split by row."""
    if x.ndim >= 2 and x.shape[0] == 3:
        return x.reshape(3, n_micro, x.shape[1] // n_micro,
                         *x.shape[2:]).transpose(0, 1)
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


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
    ``grad_shardings`` pins the accumulator's layout on a mesh in the
    reference; the port runs on one device and refuses anything but None.
    """
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings: the port's train step runs on one device; "
            "sharded accumulators come with distribution (ROADMAP §1)")
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
        if n_micro == 1:
            total, metrics, grads = value_and_grad(loss_mean, params, batch)
            return finish(params, opt_state, grads, total, metrics, step)

        if "sample_weights" not in batch:
            raise ValueError("microbatching needs sample weights")
        micro = {k: split_microbatches(v, n_micro) for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        for i in range(n_micro):
            t, _, g = value_and_grad(loss_sum, params,
                                     {k: v[i] for k, v in micro.items()})
            for acc, gi in zip(grads, g):
                if grad_wire_bf16:
                    gi = gi.to(torch.bfloat16)
                acc.add_(gi.float())
            total = total + t
        return finish(params, opt_state, grads, total,
                      {"loss": total, "aux": torch.zeros_like(total)}, step)

    return train_step

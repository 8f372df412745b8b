"""Loss and eval-step factories of the training path.

Counterpart of ``repro/train/step.py``'s ``make_loss_fn`` and
``make_eval_step``.  ScaDLES' weighted aggregation (Eqn 4) enters as
per-sample loss weights: every sample carries ``w_s = r_dev(s) / b_dev(s)``
(``sample_weights``, summing to 1 over the global batch), so the gradient
of the weighted loss is the paper's weighted aggregate.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import RunCtx, forward_hidden, lm_loss

MOE_AUX_WEIGHT = 0.01
_NOT_PORTED = ("audio_feats", "patch_embeds", "mrope_positions")


def make_loss_fn(cfg: ModelConfig, ctx: RunCtx, sum_form: bool = False):
    """-> ``loss_fn(params, batch) -> (total, {"loss", "aux"})``.

    ``sum_form``: return the weighted SUM of per-token nll (weights are
    globally normalised by the data pipeline), so microbatch gradients
    accumulate by addition without renormalisation.
    """
    def loss_fn(params, batch: Dict[str, Any]):
        extra = sorted(set(batch) & set(_NOT_PORTED))
        if extra:
            raise NotImplementedError(
                f"batch inputs {extra} belong to families the port does not "
                "cover yet (ROADMAP.md, 'Modules to port')")
        h, aux = forward_hidden(params, batch["tokens"], cfg, ctx)
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

"""LR schedules: paper-style multistep decay + warmup-cosine for examples.

Counterpart of ``repro/optim/schedules.py``.  Each schedule is a plain
function of the step, an int or a 0-d tensor; it returns a float for an int
and a 0-d float32 tensor on the step's device for a tensor, so a step count
kept on the card needs no host sync.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float):
    """Paper recipe: e.g. ResNet152 lr=0.1, x0.2 at epochs 75/150/225."""
    ms = list(milestones)

    def lr(step):
        if isinstance(step, torch.Tensor):
            n = (step >= torch.tensor(ms, device=step.device)).sum()
            return (base_lr * gamma ** n.float()).float()
        return base_lr * gamma ** sum(step >= m for m in ms)

    return lr


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    def lr(step):
        if not isinstance(step, torch.Tensor):
            return float(lr(torch.tensor(step)))
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr

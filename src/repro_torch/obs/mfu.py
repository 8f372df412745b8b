"""Model-flops utilisation of the trainer's step.

Counterpart of ``repro/obs/mfu.py``.  MFU is the paper-standard ratio: the
flops the model *needs* per step over the flops the hardware *could have
done* in the simulated round time.  The reference peak is the paper's
Table II hardware (one K80 GPU per edge device), a sim-time constant, so
MFU reads as "fraction of the fleet's K80-seconds the committed gradients
used".  It says nothing about the card the port runs on.

The reference counts flops from the lowered HLO; the port counts them with
``torch.utils.flop_counter.FlopCounterMode`` while the step runs once on
``meta``-device copies of its arguments: no work on the card, no storage,
and the caller's tensors are never touched.  Producers cache the count and
only ask for it when a tracker is active, keeping the noop path free.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

#: fp32 peak of one K80 GPU (the paper's per-device accelerator, Table II).
#: Absolute MFU values are relative to this; regression gating only needs
#: the number to be stable, not flattering.
DEVICE_PEAK_FLOPS = 4.37e12


def _on_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: _on_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_on_meta(v) for v in x)
    return x


def counted_flops(fn, *args) -> Optional[float]:
    """Flops of one call of ``fn(*args)``, counted on meta copies of the
    arguments.  None when the step cannot run on the meta device (an op
    without a meta kernel, a host read of a value) or counts nothing:
    callers treat None as "flops unavailable", never as an error."""
    try:
        meta_args = [_on_meta(a) for a in args]
        with FlopCounterMode(display=False) as counter:
            fn(*meta_args)
    except (RuntimeError, NotImplementedError):
        return None
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def mfu(step_flops: Optional[float], dt_s: float, *,
        n_devices: int = 1, peak_flops: float = DEVICE_PEAK_FLOPS) -> float:
    """Fleet MFU for one round: step flops over available device-flops.

    ``step_flops`` is the whole step (all devices' gradients: the trainer
    maps over the device axis), so the denominator spans the full fleet:
    ``dt * peak * n_devices``.
    """
    if not step_flops or dt_s <= 0.0:
        return 0.0
    return float(step_flops) / (dt_s * peak_flops * max(int(n_devices), 1))

"""PyTorch/CUDA port of the ``repro`` serving path, for one NVIDIA H100.

Laid out like ``repro`` (``configs/``, ``models/``, ``kernels/``,
``launch/``) so each module's counterpart is easy to find.  The port imports
``torch`` and numpy only; it shares no code with the JAX package.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``: :func:`resolve_device` raises when CUDA is asked for and
missing, so nothing quietly moves to the CPU.
"""
from __future__ import annotations

import sys

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and
    this process has no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``.  Until that
    module is imported no DTensor can exist, so the check imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)

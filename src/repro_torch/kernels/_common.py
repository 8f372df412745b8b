"""What the kernel wrappers share: the dtype codes their CUDA sources take
(``csrc/common.cuh``); for the attention kernels also the finite mask
value, the head sizes, the checks a launch needs and the refusal of
autograd."""
from __future__ import annotations

import torch

NEG_INF = -1e30        # finite, so a fully masked tile adds exactly 0
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_launch(q, *others) -> None:
    """Raise unless ``q`` and ``others`` can go to the kernel as they are:
    one dtype it takes, one device, contiguous, a head size it takes."""
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    dtypes = [t.dtype for t in (q, *others)]
    if q.dtype not in DTYPES or any(d != q.dtype for d in dtypes):
        raise TypeError(f"dtypes {dtypes}: the kernel takes float32 or "
                        "bfloat16, all alike")
    if any(t.device != q.device for t in others):
        raise ValueError("the kernel's inputs must be on one device")
    if not all(t.is_contiguous() for t in (q, *others)):
        raise ValueError("the kernel reads contiguous inputs")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through ``name``.

    The attention kernels have no backward (nor do the reference's Pallas
    ones), and their output carries no ``grad_fn``, so a loss reaching them
    with grad enabled would silently leave attention out of its gradient.
    Training calls the plain versions (``backend="torch"``), which autograd
    differentiates.  Raises on every device, the CPU included.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: inputs that require grad must go "
            "through the plain version (backend='torch')")

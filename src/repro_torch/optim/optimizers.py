"""Functional optimizers: momentum SGD (the paper's recipe) and Adam.

Counterpart of ``repro/optim/optimizers.py``.  States are dict trees shaped
like the params.  The non-Nesterov momentum-SGD update of each leaf is
:func:`repro_torch.kernels.block_topk.fused_sgdm`, whose arithmetic is
exactly the reference's update: the kernel on CUDA tensors, its plain
version on CPU tensors.  Nesterov momentum and Adam are plain PyTorch: the
kernel does not compute them, and the reference runs them as plain jnp too.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch import is_dtensor
from repro_torch.kernels.block_topk import fused_sgdm, fused_sgdm_ref
from repro_torch.tree import leaves, tree_map, unflatten

BACKENDS = {"kernel": fused_sgdm, "torch": fused_sgdm_ref}


def sgdm_init(params, mom_dtype=torch.float32):
    """Zero momentum for every leaf, placed as the leaf is (a ``DTensor``
    leaf gets a ``DTensor`` with its placements).  ``fused_sgdm`` keeps f32
    momentum, so a bf16 ``mom_dtype`` is updated by plain code on the CPU
    only."""
    return {"mom": tree_map(lambda p: torch.zeros_like(p, dtype=mom_dtype),
                            params)}


def _lr_tensor(lr, like: torch.Tensor) -> torch.Tensor:
    """``lr`` as a 0-d f32 tensor on the params' device, made once per
    update so no leaf waits on the host."""
    return torch.as_tensor(lr, dtype=torch.float32, device=like.device)


def sgdm_update(grads, state, params, *, lr, momentum=0.9, weight_decay=0.0,
                nesterov=False, backend: str = "kernel"):
    """One momentum-SGD step -> (params, state), both new trees.

    ``backend="kernel"`` sends each non-Nesterov f32-momentum leaf through
    ``fused_sgdm`` (the kernel on CUDA tensors); ``"torch"`` through its
    plain version on any device.  ``DTensor`` leaves update on their local
    shards, each gradient first brought to its param's placements (autograd
    may leave it partial, or otherwise placed).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {sorted(BACKENDS)}")
    flat_p = leaves(params)
    if not flat_p:
        return params, state
    lr_t = _lr_tensor(lr, flat_p[0])

    def upd(g, m, p):
        if is_dtensor(p) and is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        if not nesterov and m.dtype == torch.float32:
            return BACKENDS[backend](p, m, g, lr_t, momentum, weight_decay)
        if p.device.type == "cuda" and not nesterov:
            raise TypeError(f"momentum dtype {m.dtype}: fused_sgdm keeps the "
                            "momentum in float32 (sgdm_init's default)")
        g = g.float() + weight_decay * p.float()
        m2 = momentum * m.float() + g
        step = g + momentum * m2 if nesterov else m2
        return (p.float() - lr_t * step).to(p.dtype), m2.to(m.dtype)

    new = [upd(g, m, p) for g, m, p
           in zip(leaves(grads), leaves(state["mom"]), flat_p)]
    return (unflatten(params, [x[0] for x in new]),
            {"mom": unflatten(params, [x[1] for x in new])})


def adam_init(params):
    def z(p):
        return torch.zeros_like(p, dtype=torch.float32)

    flat = leaves(params)
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32,
                             device=flat[0].device if flat else "cpu")}


def adam_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.0):
    t = state["t"] + 1
    tf = t.float()
    flat_p = leaves(params)
    lr_t = _lr_tensor(lr, flat_p[0]) if flat_p else lr

    def upd(g, m, v, p):
        g = g.float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / (1 - b1 ** tf)
        vhat = v2 / (1 - b2 ** tf)
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr_t * step).to(p.dtype), m2, v2

    new = [upd(g, m, v, p) for g, m, v, p in
           zip(leaves(grads), leaves(state["m"]), leaves(state["v"]), flat_p)]
    return (unflatten(params, [x[0] for x in new]),
            {"m": unflatten(params, [x[1] for x in new]),
             "v": unflatten(params, [x[2] for x in new]), "t": t})


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    if name == "sgdm":
        return sgdm_init, lambda g, s, p, lr: sgdm_update(g, s, p, lr=lr, **kw)
    if name == "adam":
        return adam_init, lambda g, s, p, lr: adam_update(g, s, p, lr=lr, **kw)
    raise ValueError(name)

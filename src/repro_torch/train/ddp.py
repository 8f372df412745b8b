"""DDP-mode ScaDLES: the dense and the compressed (top-k) wire programs.

Counterpart of ``repro/train/ddp.py``.  Params are replicated on every rank
and each rank takes its rows of the global batch.  The adaptive rule changes
the *collective*: a dense all-reduce or an all-gather of packed (values,
indices).  So there are two step functions, and the host-level EWMA
controller (``core.compression.AdaptiveCompressor``) picks one per
iteration:

  dense_step      — grads -> all_reduce(r_i * g_i)                (Eqn 4b)
  compressed_step — grads -> top-k -> all_gather(r_i * vals, idx)
                    -> scatter_aggregate

Data parallelism goes through ``torch.distributed``: the world is the
default process group, or a single rank when none is initialised.  Where
the reference compiles each program over a mesh, the port runs each eagerly
on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compression as comp_lib
from repro_torch.kernels.scatter_agg import (scatter_aggregate,
                                             scatter_aggregate_ref)
from repro_torch.models.transformer import RunCtx
from repro_torch.train.step import make_loss_fn, value_and_grad
from repro_torch.tree import leaves, unflatten


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce(t: torch.Tensor, size: int) -> torch.Tensor:
    if size > 1:
        dist.all_reduce(t)
    return t


def _all_gather(t: torch.Tensor, size: int) -> torch.Tensor:
    """(k,) on every rank -> (size, k), rows in rank order."""
    if size == 1:
        return t[None]
    out = torch.empty((size * t.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous())
    return out.reshape((size,) + tuple(t.shape))


def _shard(batch: Dict[str, torch.Tensor], rank: int, size: int):
    """This rank's rows of the global batch (axis 0, contiguous blocks, as
    the reference shards the batch over the data axis)."""
    out = {}
    for key, v in batch.items():
        if v.shape[0] % size:
            raise ValueError(f"batch[{key!r}] has {v.shape[0]} rows, not a "
                             f"multiple of the world size {size}")
        per = v.shape[0] // size
        out[key] = v[rank * per:(rank + 1) * per]
    return out


def make_ddp_steps(cfg: ModelConfig, ctx: RunCtx, opt_update: Callable,
                   lr_schedule: Callable, cr: float, param_template,
                   use_scatter_agg: Optional[bool] = None,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Tuple[Callable, Callable, int, int]:
    """Returns (dense_step, compressed_step, k, n_floats).

    Both steps take ``(params, opt_state, batch, rates, step)`` and return
    ``(params, opt_state, {"loss", "gap"})``: ``batch`` is the global batch
    (each rank trains on its rows), ``rates`` the (world,) stream rates, one
    per rank.  ``k`` is the per-rank top-k of the compressed step and
    ``n_floats`` the flat gradient's length (``param_template``'s leaves
    may be on the ``meta`` device).

    ``use_scatter_agg`` routes the compressed step's aggregation through
    the ``scatter_aggregate`` kernel; ``None`` means on for CUDA tensors,
    as the reference turns its kernel on for compiled TPU runs.  Otherwise
    the step runs the plain ``index_put_(accumulate=True)`` chain, the
    reference's ``.at[].add``.  Both give the same bits.

    ``on_phase(name)``, if given, is called as each phase of a step ends:
    ``"fwd_bwd"``, ``"topk"`` (compressed step only), ``"aggregate"``,
    ``"update"``; a caller may record a CUDA event there.
    """
    loss_fn = make_loss_fn(cfg, ctx)
    n_floats = sum(p.numel() for p in leaves(param_template))
    k = max(1, int(cr * n_floats))
    phase = on_phase or (lambda name: None)

    def begin(params, batch, rates):
        rank, size = world()
        _, m, grads = value_and_grad(loss_fn, params,
                                     _shard(batch, rank, size))
        loss = m["loss"]
        flat, unflatten_fn = comp_lib.flatten_grads(unflatten(params, grads))
        del grads
        rate = rates.reshape(-1)[rank:rank + 1].float()
        total = _all_reduce(rate.clone(), size)
        w = rate / torch.clamp(total, min=1e-9)
        loss = _all_reduce(loss * w, size).reshape(())
        phase("fwd_bwd")
        return size, flat, unflatten_fn, w, loss

    def finish(params, opt_state, g_flat, unflatten_fn, step, metrics):
        lr = lr_schedule(step)
        params, opt_state = opt_update(unflatten_fn(g_flat), opt_state,
                                       params, lr)
        phase("update")
        return params, opt_state, metrics

    def dense_step(params, opt_state, batch, rates, step):
        size, flat, unflatten_fn, w, loss = begin(params, batch, rates)
        g = _all_reduce(flat.mul_(w), size)
        phase("aggregate")
        return finish(params, opt_state, g, unflatten_fn, step,
                      {"loss": loss, "gap": torch.zeros_like(loss)})

    def compressed_step(params, opt_state, batch, rates, step):
        size, flat, unflatten_fn, w, loss = begin(params, batch, rates)
        vals, idx = comp_lib.global_topk(flat, k)
        gap = comp_lib.energy_gap(flat, comp_lib.densify(vals, idx, n_floats))
        del flat
        phase("topk")
        # pack (r_i * values, indices) and gather them in rank order
        vals_all = _all_gather(vals * w, size)
        idx_all = _all_gather(idx, size)
        fused = (vals.device.type == "cuda" if use_scatter_agg is None
                 else use_scatter_agg)
        agg = scatter_aggregate if fused else scatter_aggregate_ref
        g = agg(vals_all, idx_all, n_floats)
        gap = _all_reduce(gap, size) / size
        phase("aggregate")
        return finish(params, opt_state, g, unflatten_fn, step,
                      {"loss": loss, "gap": gap})

    return dense_step, compressed_step, k, n_floats

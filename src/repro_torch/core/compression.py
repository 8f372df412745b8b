"""Adaptive Top-k gradient compression (paper §IV "High communication cost").

Counterpart of ``repro/core/compression.py``.  The rule: send Topk(g) iff
the EWMA of the *energy gap*

    gap(g) = ( ||g||^2 - ||Topk(g)||^2 ) / ||g||^2        in [0, 1]

is <= delta; otherwise send dense g.  CNC ratio = fraction of iterations
that used the compressed path.

Top-k comes in two flavours:
* :func:`global_topk` — exact top-k over the flat gradient (``torch.topk``
  on magnitudes; the compressed DDP program uses it, as the reference's
  does);
* block top-k — the Hopper kernel ``kernels/block_topk.py`` behind
  :class:`AdaptiveCompressor` with ``use_block_topk=True``: each block of
  the flat gradient keeps its proportional share of survivors.

Flat gradients list the leaves in ``jax.tree``'s order (sorted keys, see
``repro_torch/tree.py``), so a flat index names the same parameter here
and in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, unflatten


def flatten_grads(grads) -> Tuple[torch.Tensor, Callable]:
    """A tree of tensors -> (flat f32 vector, unflatten).  ``unflatten``
    maps an (n,) vector back to the tree; its leaves are views of it."""
    flat_leaves = leaves(grads)
    shapes = [l.shape for l in flat_leaves]
    sizes = [l.numel() for l in flat_leaves]
    flat = torch.cat([l.reshape(-1).float() for l in flat_leaves])

    def unflatten_fn(v):
        return unflatten(grads, [part.reshape(sh) for part, sh in
                                 zip(torch.split(v, sizes), shapes)])

    return flat, unflatten_fn


def flatten_stacked_grads(grads) -> Tuple[torch.Tensor, Callable]:
    """Grads with a leading device axis -> (D, n) flat matrix + unflatten
    that maps a single (n,) vector back to one device's gradient tree."""
    flat_leaves = leaves(grads)
    shapes = [l.shape[1:] for l in flat_leaves]
    sizes = [l[0].numel() for l in flat_leaves]
    flat = torch.cat([l.reshape(l.shape[0], -1).float()
                      for l in flat_leaves], dim=1)

    def unflatten_one(v):
        return unflatten(grads, [part.reshape(sh) for part, sh in
                                 zip(torch.split(v, sizes), shapes)])

    return flat, unflatten_one


def global_topk(flat, k: int):
    """Exact top-k by magnitude -> (values, int32 indices).  The packet's
    order is unspecified (``sorted=False``): every consumer sums by index."""
    _, idx = torch.topk(torch.abs(flat), k, sorted=False)
    return flat[idx], idx.to(torch.int32)


def densify(values, indices, n: int):
    out = torch.zeros((n,), dtype=values.dtype, device=values.device)
    return out.index_put_((indices.long(),), values)


def sparsify_mask(flat, k: int):
    """Dense tensor with all but the top-k entries zeroed."""
    v, i = global_topk(flat, k)
    return densify(v, i, flat.shape[0])


def energy_gap(flat, compressed):
    """( |g|^2 - |Topk(g)|^2 ) / |g|^2; compressed is the densified top-k."""
    e_full = torch.sum(torch.square(flat))
    e_comp = torch.sum(torch.square(compressed))
    return torch.abs(e_full - e_comp) / torch.clamp(e_full, min=1e-30)


@dataclasses.dataclass
class EWMA:
    """Exponentially weighted moving average of the energy gap."""
    alpha: float = 0.1
    value: float = 1.0     # start pessimistic: first iters send dense
    initialized: bool = False

    def update(self, x: float) -> float:
        x = float(x)
        if not self.initialized:
            self.value, self.initialized = x, True
        else:
            self.value = self.alpha * x + (1 - self.alpha) * self.value
        return self.value


@dataclasses.dataclass
class AdaptiveCompressor:
    """Host-side controller implementing the paper's communication rule."""
    cr: float = 0.1          # compression ratio (k = cr * n)
    delta: float = 0.3       # gap threshold
    alpha: float = 0.1       # EWMA smoothing
    use_block_topk: bool = False
    block_size: int = 1024

    def __post_init__(self):
        self.ewma = EWMA(alpha=self.alpha)
        self.t_compressed = 0
        self.t_uncompressed = 0
        self.floats_sent = 0.0

    def k_for(self, n: int) -> int:
        return max(1, int(self.cr * n))

    def compress(self, flat):
        if self.use_block_topk:
            return kops.block_topk_sparsify(flat, self.cr,
                                            block_size=self.block_size)
        return sparsify_mask(flat, self.k_for(flat.shape[0]))

    def decide(self, gap: float) -> bool:
        """EWMA-update the gap and return True if compression is allowed."""
        return self.ewma.update(gap) <= self.delta

    def account(self, used_compressed: bool, n: int) -> None:
        k = self.k_for(n)
        if used_compressed:
            self.t_compressed += 1
            # k values + k int32 indices on the wire
            self.floats_sent += 2 * k
        else:
            self.t_uncompressed += 1
            self.floats_sent += n

    @property
    def cnc_ratio(self) -> float:
        tot = self.t_compressed + self.t_uncompressed
        return self.t_compressed / tot if tot else 0.0

    def step(self, flat):
        """Full per-iteration rule: returns (tensor-to-send, used_compressed)."""
        comp = self.compress(flat)
        gap = float(energy_gap(flat, comp))
        use = self.decide(gap)
        self.account(use, flat.shape[0])
        return (comp if use else flat), use

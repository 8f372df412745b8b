"""Flat-vector wrappers around the block top-k and fused-SGDM kernels.

Counterpart of ``repro/kernels/ops.py``: pads a flat vector to
``(rows, block_size)`` tiles for ``block_topk``, trims the result back, and
exposes the API the compression layer consumes.  The kernel or its plain
version is chosen by the tensor's device, inside the wrappers.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import block_topk as bt


def _to_blocks(flat, block_size: int):
    """flat (n,) -> ((rows, block_size), n): zero-padded to whole blocks,
    then to a multiple of the reference's ``TILE_BLOCKS`` rows."""
    n = flat.shape[0]
    rows = -(-n // block_size)
    rows += (-rows) % bt.TILE_BLOCKS
    pad = rows * block_size - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(rows, block_size), n


def _k_for(cr: float, block_size: int) -> int:
    return max(1, int(cr * block_size))


def block_topk_sparsify(flat, cr: float, block_size: int = bt.DEFAULT_BLOCK):
    """Keep ~cr fraction per block; returns the densified sparse vector (n,)."""
    g2d, n = _to_blocks(flat, block_size)
    out, _ = bt.block_topk(g2d, _k_for(cr, block_size))
    return out.reshape(-1)[:n]


def block_topk_counts(flat, cr: float, block_size: int = bt.DEFAULT_BLOCK):
    """-> (sparse vector (n,), survivors per real block (ceil(n/bs),))."""
    g2d, n = _to_blocks(flat, block_size)
    out, cnt = bt.block_topk(g2d, _k_for(cr, block_size))
    # _to_blocks pads with zero rows; only the first ceil(n / block_size)
    # are data, so trim the counts to keep wire-cost accounting honest
    return out.reshape(-1)[:n], cnt.reshape(-1)[:-(-n // block_size)]


def fused_sgdm_flat(p, m, g, lr, momentum: float = 0.9,
                    weight_decay: float = 0.0):
    """Fused momentum-SGD on flat vectors (one pass).  The kernel takes any
    length, so unlike the reference nothing is padded to blocks."""
    return bt.fused_sgdm(p, m, g, lr, momentum=momentum,
                         weight_decay=weight_decay)

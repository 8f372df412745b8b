"""Peaks of the card and the bytes each kernel's work needs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores, the precision every cell runs in (TF32
off), and 3.35 TB/s of HBM.  Bytes: each input byte read once and each
output byte written once, whatever the kernel reads again.
"""
from __future__ import annotations

from typing import Iterable

PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4
I32 = 4


def fused_sgdm_bytes(n: int, elt: int = F32) -> int:
    """One momentum-SGD update of n parameters: p, g and the f32 momentum
    read, p and the momentum written."""
    return n * (3 * elt + 2 * F32)


def scatter_aggregate_bytes(n: int, k: int, packets: int = 1) -> int:
    """The dense n-float aggregate of ``packets`` packets of k (value,
    index) pairs: the packets read, the aggregate written."""
    return packets * k * (F32 + I32) + n * F32


def flash_decode_paged_bytes(kv_lens: Iterable[int], heads: int,
                             kv_heads: int, head_dim: int,
                             elt: int = F32) -> int:
    """One paged decode launch: every cached key and value the slots'
    kv_lens cover, and each slot's query and output.  The kv_lens and the
    block table entries are not counted (under 0.1 %)."""
    lens = list(kv_lens)
    kv = sum(lens) * 2 * kv_heads * head_dim * elt
    return kv + 2 * len(lens) * heads * head_dim * elt


def share(bytes_moved: float, seconds: float) -> float:
    """The least time the card could take, as a percentage of ``seconds``."""
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / seconds

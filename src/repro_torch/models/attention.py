"""Attention entry points of the serving path.

Counterpart of ``repro/models/attention.py``'s ``chunked_attention`` and
``decode_attention``, plus :func:`paged_decode_attention`, the dispatch the
reference's paged decode makes inline (``models/decode.py::_block_decode``).  ``backend="kernel"`` (the default) goes through the
kernel wrappers in ``repro_torch/kernels/`` (the Hopper kernel on CUDA
tensors, its plain version on CPU tensors), as the reference's
``backend="pallas"`` goes through its Pallas kernels; ``backend="torch"``
runs the plain versions on any device, as the reference's ``backend="jax"``.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                              flash_decode_paged_ref,
                                              flash_decode_ref)

BACKENDS = ("kernel", "torch")


def chunked_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                      q_offset: int = 0, backend: str = "kernel"):
    """q (b, sq, h, hd); k/v (b, sk, kv, hd) -> (b, sq, h, hd).

    ``q_offset``: global position of q[0] relative to k[0] (chunked
    prefill).  The reference's ``chunk_q``/``chunk_k`` are not taken: the
    kernel picks its own tiles and the plain version needs none.
    """
    if backend == "kernel":
        return flash_attention(q, k, v, kind=kind, window=window,
                               q_offset=int(q_offset))
    if backend == "torch":
        return flash_attention_ref(q, k, v, kind=kind, window=window,
                                   q_offset=int(q_offset))
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def decode_attention(q, k_cache, v_cache, kv_len, *, backend: str = "kernel"):
    """Single-token attention. q (b, 1, h, hd); caches (b, S, kv, hd).

    ``kv_len`` is a scalar (whole-batch cache length) or a (b,) vector of
    per-slot lengths.  No ``kind``/``window``: a sliding window is carried by
    the ring cache, whose storage order does not matter after RoPE.
    """
    if backend == "kernel":
        return flash_decode(q, k_cache, v_cache, kv_len)
    if backend == "torch":
        return flash_decode_ref(q, k_cache, v_cache, kv_len)
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def paged_decode_attention(q, k_pool, v_pool, bt, kv_len, *,
                           backend: str = "kernel"):
    """Single-token attention through a block table.  q (b, 1, h, hd); pools
    (rows, pg, kv, hd); bt (b, ncols) int32.  ``"kernel"`` resolves the table
    inside the kernel; ``"torch"`` gathers ``pool[bt]`` into the contiguous
    view first, as the reference's jax path does."""
    if backend == "kernel":
        return flash_decode_paged(q, k_pool, v_pool, bt, kv_len)
    if backend == "torch":
        return flash_decode_paged_ref(q, k_pool, v_pool, bt, kv_len)
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")

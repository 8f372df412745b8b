"""Compressed-DDP aggregation of top-k packets: CUDA kernel + plain version.

Counterpart of ``repro/kernels/scatter_agg.py::scatter_aggregate`` (the TPU
kernel ``_scatter_agg_kernel``).  The kernel is ``csrc/scatter_agg.cu``,
written by hand for Hopper (sm_90a); the source's header says what bounds
it and how.

``vals (D, k)`` float32 and ``idx (D, k)`` int32 are D devices' weighted
top-k packets, indices unique within a packet; the result is the flat
``(n,)`` sum, each packet added in packet order, bit-exact with the
reference's ``zeros(n).at[idx.reshape(-1)].add(vals.reshape(-1))``.

* :func:`scatter_aggregate` — the wrapper.  For CPU tensors it runs the
  plain version; for CUDA tensors it launches the kernel or raises, never
  falls back.  ``launches`` counts its kernel launches (one per call).
* :func:`scatter_aggregate_ref` — the plain version: ``zeros(n)`` then one
  ``index_put_(accumulate=True)`` per packet, in packet order.  With unique
  indices in a packet, each entry is added to once per packet, so the sum
  runs in the reference's order on any device, whatever order a single
  ``index_put_`` over all packets would take for repeated indices.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches made by scatter_aggregate (not by the plain version)


def scatter_aggregate_ref(vals, idx, n: int):
    """Plain PyTorch version of the kernel (any device)."""
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    for d in range(vals.shape[0]):
        out.index_put_((idx[d].long(),), vals[d], accumulate=True)
    return out


_ARGTYPES = {"scatter_aggregate": [ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p]}


def _check(vals, idx, n: int) -> None:
    if vals.ndim != 2 or idx.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and idx "
                         f"{tuple(idx.shape)} must both be (D, k)")
    if vals.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"vals {vals.dtype}, idx {idx.dtype}: the kernel "
                        "takes float32 values and int32 indices")
    if idx.device != vals.device:
        raise ValueError("the kernel's inputs must be on one device")
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the kernel reads contiguous packets")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"n = {n}: int32 indices address fewer than 2**31")


def scatter_aggregate(vals, idx, n: int):
    """vals (D, k) f32, idx (D, k) int32 -> flat (n,) f32 sum.

    The kernel on CUDA tensors, the plain version on CPU tensors.
    """
    global launches
    if vals.device.type == "cpu":
        return scatter_aggregate_ref(vals, idx, n)
    if vals.device.type != "cuda":
        raise ValueError(f"no scatter_aggregate for device {vals.device}")
    _check(vals, idx, n)
    D, k = vals.shape
    out = torch.empty((n,), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    lib = _build.load("scatter_agg", _ARGTYPES)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.scatter_aggregate(vals.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), n, D, k, stream)
    _build.check(lib, err, "scatter_aggregate")
    launches += 1
    return out

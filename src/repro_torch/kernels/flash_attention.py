"""Flash-attention forward (serving prefill): CUDA kernel + plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (the TPU kernel
``flash_attention_fwd``).  The kernel is ``csrc/flash_attention.cu``, written
by hand for Hopper (sm_90a): wgmma on the tensor cores (bf16; 3xTF32 for
f32) fed by a TMA ring, f32 at hd 256 split over a cluster of two blocks;
the source's header says what bounds it and how.

* :func:`flash_attention` — the wrapper.  For CPU tensors it runs the plain
  version; for CUDA tensors it launches the kernel or raises, never falls
  back.  ``launches`` counts its kernel launches.
* :func:`query_tile` — queries per block (per cluster at f32 hd 256),
  chosen per call from sq and passed to the kernel.  The wrapper refuses tensors TMA cannot read
  (``check_aligned``: 16-byte bases and strides).
* :func:`flash_attention_ref` — the plain PyTorch version: one masked
  softmax over all keys with f32 scores, the finite ``NEG_INF`` and the
  ``max(l, 1e-30)`` floor of the kernel.  It shares no tiling with the
  kernel, so it is an independent yardstick.

Both refuse (``ValueError``) a ``swa`` call whose last query's window holds
no key, ``q_offset + sq - window >= sk``: the kernel would visit no key
tile and return 0 for such a row, the plain version the uniform average of
all keys, and the reference's ``chunked_attention`` raises there too.

Layouts match the reference's public ones: q (b, sq, h, hd), k/v
(b, sk, kv, hd) -> (b, sq, h, hd) in q's dtype.  GQA reads K/V by kv-head
index; nothing is repeated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (DTYPES, NEG_INF, check_aligned,
                                         check_launch, refuse_grad)

KINDS = {"causal": 0, "swa": 1, "bidir": 2}

launches = 0  # kernel launches made by flash_attention (not by the plain version)


def check_window(kind: str, window: int, q_offset: int, sq: int,
                 sk: int) -> None:
    """Raise for a ``swa`` call whose last query (position ``q_offset + sq
    - 1``) sees no key: its window ``(pos - window, pos]`` starts at or
    past ``sk``.  The last row is the first to go empty, so this covers
    every row."""
    if kind == "swa" and window > 0 and q_offset + sq - window >= sk:
        raise ValueError(
            f"swa window {window} at q_offset {q_offset} leaves query "
            f"{q_offset + sq - 1} no key among {sk}")


def flash_attention_ref(q, k, v, *, kind: str = "causal", window: int = 0,
                        q_offset: int = 0):
    """Plain PyTorch version of the kernel (any device)."""
    if kind not in KINDS:
        raise ValueError(f"unknown mask kind {kind!r}")
    b, sq, h, hd = q.shape
    check_window(kind, window, q_offset, sq, k.shape[1])
    _, sk, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    if kind != "bidir":
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if kind == "swa" and window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def query_tile(sq: int, hd: int, dtype) -> int:
    """Queries per block: 128 (two consumer warpgroups of 64 rows) unless
    the call has at most 64 queries, where a second warpgroup would idle.
    f32 at hd 128 takes 64 only (its Q planes fill shared memory), as does
    f32 at hd 256, whose 64 queries go to a cluster of two blocks that
    each hold half of the head dim."""
    if dtype == torch.float32 and hd >= 128:
        return 64
    return 128 if sq > 64 else 64


_ARGTYPES = {"flash_attention_fwd": [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p],
             "flash_attention_smem": [ctypes.c_int] * 3}


def _check(q, k, v, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown mask kind {kind!r}")
    if not (q.ndim == k.ndim == v.ndim == 4) or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    check_launch(q, k, v)
    check_aligned(q=q, k=k, v=v)


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    q_offset: int = 0):
    """q (b, sq, h, hd); k/v (b, sk, kv, hd) -> (b, sq, h, hd).

    The kernel on a CUDA tensor, the plain version on a CPU tensor.  No
    backward: raises if autograd would need one (``refuse_grad``).
    """
    global launches
    refuse_grad("flash_attention", q, k, v)
    check_window(kind, window, q_offset, q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kind=kind, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check(q, k, v, kind)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    check_aligned(o=o)
    lib = _build.load("flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk,
            h, kvh, hd, DTYPES[q.dtype], KINDS[kind], int(window),
            int(q_offset), hd ** -0.5, query_tile(sq, hd, q.dtype), stream)
    _build.check(lib, err, "flash_attention_fwd")
    launches += 1
    return o

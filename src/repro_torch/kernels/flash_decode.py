"""Flash-decode over contiguous slot caches and paged pools: CUDA kernel +
plain versions.

Counterpart of ``repro/kernels/flash_decode.py``: ``flash_decode`` (the TPU
kernel ``_decode_kernel``) and ``flash_decode_paged`` (``_paged_decode_
kernel``).  Both launch one kernel body of ``csrc/flash_decode.cu``, written
by hand for Hopper (sm_90a), which differs between them only in how it
addresses a K/V row; the source's header says what bounds it and how.

* :func:`flash_decode` / :func:`flash_decode_paged` — the wrappers.  For
  CPU tensors they run the plain version; for CUDA tensors they launch the
  kernel or raise, never fall back.  ``launches`` / ``paged_launches``
  count their kernel launches.
* :func:`flash_decode_ref` — the plain PyTorch version, the reference's
  ``decode_attention`` jax path: f32 scores, ``kv_len`` masking, softmax,
  then ``p`` cast to the cache dtype for the PV product (the kernel keeps
  ``p`` in f32, so the two differ by bf16 rounding on bf16 caches).
* :func:`flash_decode_paged_ref` — the reference's own oracle of the paged
  kernel: gather ``pool[bt]`` into the contiguous view, then
  :func:`flash_decode_ref`.
* :func:`split_geometry` — the kernel's split rule, (number of splits, keys
  per split) as a function of (b, kv, S); its one copy: the wrappers pass
  its result to the kernel, which checks it and holds no rule of its own.

q (b, 1, h, hd); caches (b, S, kv, hd), fixed-slot rows or SWA rings; pools
(rows, pg, kv, hd) behind a (b, ncols) int32 block table; ``kv_len`` a
scalar or a (b,) vector of per-slot valid lengths.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (DTYPES, NEG_INF, check_aligned,
                                         check_launch, refuse_grad)

MAX_GROUP = 16          # query heads per kv head the kernel takes
SPLIT_UNIT = 64         # keys; every split boundary is a multiple
MAX_SPLIT = 8           # splits per (slot, kv head): the cluster size
TARGET_BLOCKS = 96      # blocks the split rule aims for (see the source)

launches = 0  # kernel launches made by flash_decode (not by the plain version)
paged_launches = 0  # the same for flash_decode_paged


def _kv_len_vector(kv_len, b: int, device) -> torch.Tensor:
    """Scalar (lockstep) or (b,) per-slot lengths -> (b,) int32 on device;
    a (b,) int32 contiguous tensor on ``device`` passes through uncopied."""
    kvl = torch.as_tensor(kv_len, device=device).to(torch.int32).reshape(-1)
    return kvl.expand(b).contiguous()


def flash_decode_ref(q, k_cache, v_cache, kv_len):
    """Plain PyTorch version of the kernel (any device)."""
    b, _, h, hd = q.shape
    _, S, kvh, _ = k_cache.shape
    g = h // kvh
    qh = q.reshape(b, kvh, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                     k_cache.float()) * hd ** -0.5
    lens = _kv_len_vector(kv_len, b, q.device).reshape(-1, 1)
    valid = torch.arange(S, device=q.device)[None, :] < lens       # (b, S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, hd)


def flash_decode_paged_ref(q, k_pool, v_pool, bt, kv_len):
    """Plain PyTorch version of the paged kernel (any device): the slots'
    pages gathered into (b, ncols * pg, kv, hd) views, then
    :func:`flash_decode_ref`."""
    b = q.shape[0]
    _, pg, kvh, hd = k_pool.shape
    S = bt.shape[-1] * pg
    rows = bt.long()
    return flash_decode_ref(q, k_pool[rows].reshape(b, S, kvh, hd),
                            v_pool[rows].reshape(b, S, kvh, hd), kv_len)


def split_geometry(b: int, kvh: int, S: int) -> tuple:
    """(nsplit, keys_per_split) of the kernel's split-K at logical length
    S: a function of (b, kv, S) only, so the paged entry (S = ncols * pg)
    and the contiguous one split equal S alike.  Split r covers keys
    [r * keys_per_split, min((r + 1) * keys_per_split, S)); boundaries are
    multiples of SPLIT_UNIT, and no split starts at or past S."""
    if b <= 0 or kvh <= 0 or S <= 0:
        raise ValueError(f"no split of b={b} kv={kvh} S={S}")
    units = -(-S // SPLIT_UNIT)
    want = -(-TARGET_BLOCKS // (b * kvh))
    n = max(1, min(want, MAX_SPLIT, units))
    per = -(-units // n)
    return -(-units // per), per * SPLIT_UNIT


_ARGTYPES = {"flash_decode": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p],
             "flash_decode_paged": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p]}


def _check(q, k_cache, v_cache) -> None:
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    b, _, h, hd = q.shape
    _, _, kvh, khd = k_cache.shape
    if k_cache.shape[0] != b or khd != hd or h % kvh:
        raise ValueError(f"q{tuple(q.shape)} does not match "
                         f"caches {tuple(k_cache.shape)}")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    check_launch(q, k_cache, v_cache)
    check_aligned(q=q, k_cache=k_cache, v_cache=v_cache)


def flash_decode(q, k_cache, v_cache, kv_len):
    """q (b, 1, h, hd); caches (b, S, kv, hd) -> (b, 1, h, hd).

    The kernel on a CUDA tensor, the plain version on a CPU tensor.  No
    backward: raises if autograd would need one (``refuse_grad``).
    """
    global launches
    refuse_grad("flash_decode", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode for device {q.device}")
    _check(q, k_cache, v_cache)
    b, _, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    kvl = _kv_len_vector(kv_len, b, q.device)
    o = torch.empty_like(q)
    check_aligned(o=o)
    lib = _build.load("flash_decode", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kvl.data_ptr(), o.data_ptr(), b, S, h, kvh, hd, DTYPES[q.dtype],
            *split_geometry(b, kvh, S), hd ** -0.5, stream)
    _build.check(lib, err, "flash_decode")
    launches += 1
    return o


def _check_paged(q, k_pool, v_pool, bt) -> None:
    if q.ndim != 4 or q.shape[1] != 1 or k_pool.ndim != 4 \
            or k_pool.shape != v_pool.shape or bt.ndim != 2:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k_pool.shape)}"
                         f" v{tuple(v_pool.shape)} bt{tuple(bt.shape)}")
    b, _, h, hd = q.shape
    _, _, kvh, khd = k_pool.shape
    if bt.shape[0] != b or khd != hd or h % kvh:
        raise ValueError(f"q{tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} and bt{tuple(bt.shape)}")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if bt.dtype != torch.int32:
        raise TypeError(f"bt is {bt.dtype}; the kernel reads int32")
    if bt.device != q.device or not bt.is_contiguous():
        raise ValueError("bt must be contiguous and on q's device")
    check_launch(q, k_pool, v_pool)
    check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)


def flash_decode_paged(q, k_pool, v_pool, bt, kv_len):
    """q (b, 1, h, hd); pools (rows, pg, kv, hd); bt (b, ncols) int32 pool
    rows of each slot's logical pages -> (b, 1, h, hd).

    The slot's key j is ``pool[bt[slot, j // pg], j % pg]``; ``kv_len``
    counts keys over the logical length ``S = ncols * pg``.  The kernel on a
    CUDA tensor, the plain version on a CPU tensor.  ``bt``'s entries must
    be rows of the pools (the page tables of ``models/decode.py`` guarantee
    it; the kernel does not check).  Pools may be views of a stacked unit
    cache (``take``), as long as each is contiguous and starts on a 16-byte
    boundary (``check_aligned``).  No backward.
    """
    global paged_launches
    refuse_grad("flash_decode_paged", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, k_pool, v_pool, bt, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode_paged for device {q.device}")
    _check_paged(q, k_pool, v_pool, bt)
    b, _, h, hd = q.shape
    rows, pg, kvh, _ = k_pool.shape
    ncols = bt.shape[1]
    kvl = _kv_len_vector(kv_len, b, q.device)
    o = torch.empty_like(q)
    check_aligned(o=o)
    lib = _build.load("flash_decode", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
            kvl.data_ptr(), o.data_ptr(), b, rows, pg, ncols, h, kvh, hd,
            DTYPES[q.dtype], *split_geometry(b, kvh, ncols * pg), hd ** -0.5,
            stream)
    _build.check(lib, err, "flash_decode_paged")
    paged_launches += 1
    return o

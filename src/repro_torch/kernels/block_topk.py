"""Block-local top-k and fused momentum-SGD: CUDA kernels + plain versions.

Counterpart of ``repro/kernels/block_topk.py`` (the TPU kernels
``_block_topk_call`` and ``fused_sgdm``) and of ``repro/kernels/ref.py``'s
oracles.  The kernels are ``csrc/block_topk.cu`` and ``csrc/fused_sgdm.cu``,
written by hand for Hopper (sm_90a); each source's header says what bounds
it and how.

* :func:`block_topk` — per row of ``(n_blocks, bs)``, keep the entries
  whose magnitude reaches a threshold found by a 20-step f32 bisection, so
  about ``k`` survive; returns the masked rows and an int32 count per row.
  Differentiable: the backward is the reference's straight-through mask,
  ``where(out != 0, d_out, 0)`` (a ``jnp.where`` there, a plain op here).
* :func:`fused_sgdm` — ``g' = g + wd p; m' = mu m + g'; p' = p - lr m'`` in
  f32 over tensors of any shape, ``m`` in f32, ``lr`` a scalar or a 0-d
  tensor.

Each wrapper runs its plain version (:func:`block_topk_ref`,
:func:`fused_sgdm_ref`) on CPU tensors and launches its kernel or raises on
CUDA tensors, never falls back.  ``launches`` counts kernel launches by
wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPES

N_BISECT = 20
DEFAULT_BLOCK = 1024
TILE_BLOCKS = 8          # the reference's rows per program; ops pads to it
BLOCK_SIZES = (128, 256, 512, 1024, 2048)

# kernel launches by wrapper (not by the plain versions)
launches = {"block_topk": 0, "fused_sgdm": 0}

# ---------------------------------------------------------------------------
# block_topk


def _bisect_threshold(mag, k: int):
    """Per-row threshold: mag (rows, block) f32 -> tau (rows, 1)."""
    hi = torch.amax(mag, dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum(mag >= mid, dim=-1, keepdim=True, dtype=torch.int32)
        gt = cnt > k
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    return hi


def block_topk_ref(g2d, k: int):
    """Plain PyTorch version of the kernel (any device), no autograd rule."""
    mag = torch.abs(g2d.float())
    tau = _bisect_threshold(mag, k)
    keep = (mag >= tau) & (mag > 0)   # all-zero row -> 0 survivors
    out = torch.where(keep, g2d, torch.zeros_like(g2d))
    cnt = torch.sum(keep, dim=-1, keepdim=True, dtype=torch.int32)
    return out, cnt


_TOPK_ARGTYPES = {"block_topk": [ctypes.c_void_p] * 3
                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]}


def _block_topk_kernel(g2d, k: int):
    if g2d.ndim != 2 or g2d.shape[1] not in BLOCK_SIZES:
        raise ValueError(f"g2d {tuple(g2d.shape)}: the kernel takes "
                         f"(n_blocks, bs) with bs in {BLOCK_SIZES}")
    if g2d.dtype not in DTYPES:
        raise TypeError(f"{g2d.dtype}: the kernel takes float32 or bfloat16")
    if not g2d.is_contiguous():
        raise ValueError("the kernel reads a contiguous g2d")
    rows, bs = g2d.shape
    out = torch.empty_like(g2d)
    cnt = torch.empty((rows, 1), dtype=torch.int32, device=g2d.device)
    if rows == 0:
        return out, cnt
    lib = _build.load("block_topk", _TOPK_ARGTYPES)
    with torch.cuda.device(g2d.device):
        stream = torch.cuda.current_stream(g2d.device).cuda_stream
        err = lib.block_topk(g2d.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                             rows, bs, int(k), DTYPES[g2d.dtype], stream)
    _build.check(lib, err, "block_topk")
    launches["block_topk"] += 1
    return out, cnt


class _BlockTopk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g2d, k):
        if g2d.device.type == "cpu":
            out, cnt = block_topk_ref(g2d, k)
        elif g2d.device.type == "cuda":
            out, cnt = _block_topk_kernel(g2d, k)
        else:
            raise ValueError(f"no block_topk for device {g2d.device}")
        # survivors never hold 0 (the mag > 0 guard), so out != 0 is the
        # keep mask: the backward needs no second bisection
        ctx.save_for_backward(out)
        ctx.mark_non_differentiable(cnt)
        return out, cnt

    @staticmethod
    def backward(ctx, d_out, d_cnt):
        out, = ctx.saved_tensors
        return torch.where(out != 0, d_out, torch.zeros_like(d_out)), None


def block_topk(g2d, k: int):
    """g2d (n_blocks, bs) -> (sparsified g2d, counts (n_blocks, 1) int32).

    ``k`` survivors per row (about: ties at the threshold all survive).
    The kernel on a CUDA tensor, the plain version on a CPU tensor.
    """
    return _BlockTopk.apply(g2d, int(k))


# ---------------------------------------------------------------------------
# fused momentum-SGD


def fused_sgdm_ref(p, m, g, lr, momentum: float = 0.9,
                   weight_decay: float = 0.0):
    """Plain PyTorch version of the kernel (any device): (p', m')."""
    p32 = p.float()
    g32 = g.float() + weight_decay * p32
    m2 = momentum * m + g32
    return (p32 - lr * m2).to(p.dtype), m2


_SGDM_ARGTYPES = {"fused_sgdm": [ctypes.c_void_p] * 6
                  + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                     ctypes.c_int, ctypes.c_void_p]}


def fused_sgdm(p, m, g, lr, momentum: float = 0.9,
               weight_decay: float = 0.0):
    """One momentum-SGD step over tensors of any shape -> (p', m').

    p, g: same shape and dtype (float32 or bfloat16); m: float32; lr: a
    number or a 0-d float32 tensor (on the card, for a CUDA launch).  The
    kernel on CUDA tensors, the plain version on CPU tensors.

    ``DTensor``s p, m, g with equal placements on one mesh update their
    local shards (the update is elementwise, so a rank's update is the
    global one restricted to its shard) and come back with those
    placements; unequal placements, or ``DTensor``s beside plain tensors,
    raise.
    """
    dts = [is_dtensor(t) for t in (p, m, g)]
    if any(dts):
        return _fused_sgdm_sharded(p, m, g, lr, momentum, weight_decay,
                                   all(dts))
    if p.device.type == "cpu":
        return fused_sgdm_ref(p, m, g, lr, momentum, weight_decay)
    if p.device.type != "cuda":
        raise ValueError(f"no fused_sgdm for device {p.device}")
    if not (p.shape == m.shape == g.shape):
        raise ValueError(f"shapes p{tuple(p.shape)} m{tuple(m.shape)} "
                         f"g{tuple(g.shape)} differ")
    if p.dtype not in DTYPES or g.dtype != p.dtype or m.dtype != torch.float32:
        raise TypeError(f"dtypes p {p.dtype}, m {m.dtype}, g {g.dtype}: the "
                        "kernel takes p and g float32 or bfloat16 alike, m "
                        "float32")
    if any(t.device != p.device for t in (m, g)):
        raise ValueError("the kernel's inputs must be on one device")
    if not all(t.is_contiguous() for t in (p, m, g)):
        raise ValueError("the kernel reads contiguous inputs")
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=p.device)
    if lr_t.numel() != 1:
        raise ValueError(f"lr must be a scalar, got shape {tuple(lr_t.shape)}")
    p_out = torch.empty_like(p)
    m_out = torch.empty_like(m)
    if p.numel() == 0:
        return p_out, m_out
    lib = _build.load("fused_sgdm", _SGDM_ARGTYPES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.fused_sgdm(p.data_ptr(), m.data_ptr(), g.data_ptr(),
                             lr_t.data_ptr(), p_out.data_ptr(),
                             m_out.data_ptr(), p.numel(), float(momentum),
                             float(weight_decay), DTYPES[p.dtype], stream)
    _build.check(lib, err, "fused_sgdm")
    launches["fused_sgdm"] += 1
    return p_out, m_out


def _fused_sgdm_sharded(p, m, g, lr, momentum, weight_decay, all_dt):
    """:func:`fused_sgdm` on the local shards of ``DTensor``s p, m, g; the
    results rewrapped with p's mesh and placements."""
    from torch.distributed.tensor import DTensor
    if not all_dt:
        raise TypeError("fused_sgdm: p, m and g must all be DTensors or all "
                        "plain tensors")
    if not (p.device_mesh == m.device_mesh == g.device_mesh
            and tuple(p.placements) == tuple(m.placements)
            == tuple(g.placements)):
        raise ValueError(f"fused_sgdm: placements p {p.placements}, m "
                         f"{m.placements}, g {g.placements} (or meshes) "
                         "differ")
    if is_dtensor(lr):
        lr = lr.to_local()
    p_out, m_out = fused_sgdm(*(t.to_local().contiguous() for t in (p, m, g)),
                              lr, momentum, weight_decay)
    return tuple(DTensor.from_local(t, p.device_mesh, p.placements,
                                    shape=p.shape, stride=p.stride())
                 for t in (p_out, m_out))

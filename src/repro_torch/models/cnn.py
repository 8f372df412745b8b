"""Small CNN classifier for the paper-faithful convergence experiments.

Counterpart of ``repro/models/cnn.py``: a VGG-style conv stack on 32x32x3
inputs standing in for the paper's ResNet152/VGG19 on CIFAR.  As in the
reference, no trainer uses it.

The param layout is the reference's, so conversion is a checked tree map
(``convert.cnn_params_from_jax``) and a flat vector keeps ``jax.tree``'s
leaf order: ``conv`` is a list of ``{w: (3, 3, Cin, Cout) HWIO, b}``, then
``fc1`` and ``fc2`` of ``{w: (d_in, d_out), b}``.  Images are NHWC, as in
the reference; the forward permutes to NCHW / OIHW for ``F.conv2d``.

cuDNN may run f32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32``
is True by default), which the reference's f32 convolutions do not.  The
convolutions here run in full f32, forward and backward, whatever that flag
says: it is turned off around each convolution and the caller's setting
restored after it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def init_cnn(gen: Optional[torch.Generator], cfg: ModelConfig,
             device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random params from ``gen`` (a generator on ``device``), He-scaled
    as in the reference, biases zero.  ``device="meta"`` (with
    ``gen=None``) gives the shapes without storage."""
    dev = resolve_device(device)
    ch = cfg.d_model  # base width
    widths = [3] + [min(ch * (2 ** i), 4 * ch) for i in range(cfg.num_layers)]

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * scale).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    params: Dict[str, Any] = {"conv": []}
    for i in range(cfg.num_layers):
        fan_in = widths[i] * 9
        params["conv"].append({
            "w": normal((3, 3, widths[i], widths[i + 1]),
                        (2.0 / fan_in) ** 0.5),
            "b": zeros(widths[i + 1])})
    d_last = widths[-1]
    params["fc1"] = {"w": normal((d_last, cfg.d_ff), (2.0 / d_last) ** 0.5),
                     "b": zeros(cfg.d_ff)}
    params["fc2"] = {"w": normal((cfg.d_ff, cfg.vocab_size),
                                (1.0 / cfg.d_ff) ** 0.5),
                     "b": zeros(cfg.vocab_size)}
    return params


@contextlib.contextmanager
def _full_f32():
    """cuDNN's TF32 off inside the block, the caller's setting restored on
    exit (the CPU's convolutions ignore the flag)."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


class _Conv3x3(torch.autograd.Function):
    """3x3 SAME convolution, stride 1, NCHW / OIHW, with TF32 off in the
    forward and in the backward: autograd runs the backward after the
    forward's ``with`` block has closed, so the flag is set there again."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with _full_f32():
            return F.conv2d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _full_f32():
            return torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, list(ctx.needs_input_grad))


def cnn_forward(params, images: torch.Tensor, cfg: ModelConfig):
    """images (b, 32, 32, 3) NHWC -> logits (b, classes)."""
    x = images.permute(0, 3, 1, 2)
    for p in params["conv"]:
        x = torch.relu(_Conv3x3.apply(x, p["w"].permute(3, 2, 0, 1), p["b"]))
        # 2x2 max-pool each stage (the reference's -inf-initialised VALID
        # reduce_window; every stage's size is even)
        x = F.max_pool2d(x, 2)
    x = torch.mean(x, dim=(2, 3))  # global average pool
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def cnn_loss(params, images: torch.Tensor, labels: torch.Tensor,
             cfg: ModelConfig):
    """Mean cross-entropy of ``cnn_forward``'s logits (f32)."""
    logits = cnn_forward(params, images, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - gold)

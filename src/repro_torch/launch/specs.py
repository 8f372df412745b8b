"""Stand-ins for every model input on the ``meta`` device: shapes and
dtypes, no storage (the dry run's working set).

Counterpart of ``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s
become ``meta`` tensors; :func:`concretize` makes small deterministic
tensors of them for tests.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.decode import init_cache
from repro_torch.models.transformer import RunCtx
from repro_torch.tree import tree_map


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      weighted: bool = True) -> Dict[str, Any]:
    """Batch for a train/prefill step: tokens/labels (+ modality extras)."""
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": sds((b, s), torch.int32),
        "labels": sds((b, s), torch.int32),
    }
    if weighted and shape.kind == "train":
        batch["sample_weights"] = sds((b,), torch.float32)
    if cfg.family == "audio":
        batch["audio_feats"] = sds((b, cfg.encoder_seq_len, cfg.d_model),
                                   torch.bfloat16)
    if cfg.family == "vlm":
        batch["patch_embeds"] = sds((b, cfg.num_patch_tokens, cfg.d_model),
                                    torch.bfloat16)
        batch["mrope_positions"] = sds((3, b, s), torch.int32)
    return batch


def decode_inputs(cfg: ModelConfig, shape: InputShape, ctx: RunCtx,
                  long_context: bool) -> Tuple[Dict[str, Any], Any]:
    """(token stand-ins, cache stand-ins) for a decode step at this shape."""
    b, s = shape.global_batch, shape.seq_len
    pattern = cfg.pattern_for_long_context() if long_context else None
    cache = init_cache(cfg, b, s, ctx, pattern=pattern, as_spec=True)
    toks = {"tokens": sds((b, 1), torch.int32)}
    return toks, cache


def concretize(spec_tree, seed: int = 0, device: str = "cuda"):
    """Materialise ``meta`` stand-ins as small deterministic tensors on
    ``device`` (tests): integers 0, floats 0.01.  ``seed`` is kept for the
    reference's signature; nothing is drawn."""
    del seed
    dev = resolve_device(device)

    def one(s):
        if s.dtype.is_floating_point:
            return torch.full(s.shape, 0.01, dtype=s.dtype, device=dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    return tree_map(one, spec_tree)

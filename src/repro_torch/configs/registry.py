"""Architecture registry: ``get_config("<arch-id>")`` for every assigned arch."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

# arch-id (as passed to --arch) -> module name in repro_torch.configs
_ARCH_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internlm2-20b": "internlm2_20b",
    "mixtral-8x22b": "mixtral_8x22b",
    "whisper-base": "whisper_base",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "xlstm-125m": "xlstm_125m",
    "mistral-large-123b": "mistral_large_123b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "paper-cnn": "paper_cnn",
}

ASSIGNED_ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "paper-cnn"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ASSIGNED_ARCHS}


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]

"""The program under test, as the benchmark drives it: the port's
``ModelConfig`` and ``RunCtx`` from a configuration file's ``program``
section, its kernels built before the first call, and a slot runner that
serves the benchmark's own prompts."""
from __future__ import annotations

from typing import Dict, Iterable

import torch

# the configuration file's Hugging Face keys, under the program's names
_KEYS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
         "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
         "intermediate_size": "d_ff", "num_hidden_layers": "num_layers",
         "vocab_size": "vocab_size", "tie_word_embeddings": "tie_embeddings",
         "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
         "attention_bias": "qkv_bias"}
_MOE_KEYS = {"num_local_experts": "num_experts",
             "num_experts_per_tok": "top_k"}


def model_config(cfg: dict):
    """The port's ``ModelConfig`` from a configuration file: every size from
    its Hugging Face keys, and from its ``program`` section only what the
    published config has no key for (the family, the MoE's capacity and
    group)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    if cfg.get("sliding_window") and cfg.get("use_sliding_window", True):
        raise ValueError(f"{cfg['name']}: windowed attention is not mapped")
    prog = cfg["program"]
    kw = {name: cfg[key] for key, name in _KEYS.items() if key in cfg}
    moe = None
    if cfg.get("num_local_experts"):
        moe = MoEConfig(**{name: cfg[key] for key, name in _MOE_KEYS.items()},
                        **prog.get("moe", {}))
    return ModelConfig(name=cfg["name"], family=prog["family"], moe=moe,
                       **kw)


def run_ctx(cfg: dict, device: torch.device):
    from repro_torch.models.transformer import RunCtx
    return RunCtx(device=str(device), **cfg["program"].get("run_ctx", {}))


def check_params(cfg: dict, weights: Dict) -> None:
    """Raise unless the program lays its parameters out as the benchmark
    made them."""
    from bench.weights import check_against
    from repro_torch.models.transformer import init_params
    check_against(weights, init_params(None, model_config(cfg),
                                       device="meta"))


def prebuild(names: Iterable[str], device: torch.device) -> None:
    """Build (or find built) the named kernels, all nvcc runs at once."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(list(names))


def slot_runner(weights, cfg: dict, device, **kw):
    """A ``SlotRunner`` that prefills the benchmark's prompt for each
    request id (``runner.prompts[rid]``, (1, P) int64 on the host) and
    keeps, on the device, the logit of each token it chose at its last
    sampling (``runner.chosen_logits``, one a row of that call)."""
    from repro_torch.serve.engine import SlotRunner

    class BenchRunner(SlotRunner):
        prompts: Dict[int, torch.Tensor] = {}
        chosen_logits = None

        def prompt_tokens(self, req):
            return self.prompts[req.rid]

        def _sample(self, logits):
            tok = super()._sample(logits)
            self.chosen_logits = logits.gather(-1, tok[:, None])[:, 0]
            return tok

    runner = BenchRunner(weights, model_config(cfg), run_ctx(cfg, device),
                         **kw)
    runner.prompts = {}
    return runner


def request(rid: int, prompt_len: int, max_new: int):
    from repro_torch.serve.requests import Request
    return Request(rid=rid, arrival_s=0.0, prompt_len=prompt_len,
                   max_new_tokens=max_new, deadline_s=float("inf"))

"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same configuration keys, drivers, limits and code paths."""
from __future__ import annotations

import copy
import time

import torch

from bench import harness

TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 96,
        "num_hidden_layers": 2, "vocab_size": 256}
TRAIN = {"batch": 4, "seq": 16, "trace_steps": 1}
SERVE = {"clients": 3, "cache_len": 40, "page_size": 4, "prefill_chunk": 8,
         "prompt_len": {"dist": "log_normal", "median": 10, "mean": 11},
         "output_len": {"dist": "log_normal", "median": 4, "mean": 5},
         "pool": 16, "compared_requests": 4, "trace_steps": 2}


def tiny_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg.update(TINY)
    if "moe" in cfg["program"]:
        cfg["program"]["moe"]["group_size"] = 64
    cfg["program"]["run_ctx"] = {**cfg["program"].get("run_ctx", {}),
                                 "loss_chunk": 8, "chunk_q": 8, "chunk_k": 8}
    return cfg


def tiny_cell(name: str, seed: int = 5, seconds: float = 0.2,
              trace: int = 0, **wl_extra):
    """(BENCHMARK.json, Spec) of cell ``name`` cut to a tiny size on the
    CPU."""
    bm, _, wl, cfg = harness.load_cell(name)
    wl = copy.deepcopy(wl)
    wl.update(TRAIN if wl["driver"] == "train_ddp" else SERVE)
    wl.update(wl_extra)
    spec = harness.Spec(cell=name, wl=wl, cfg=tiny_config(cfg), seed=seed,
                        seconds=seconds, trace=trace,
                        device=torch.device("cpu"), t_start=time.time(),
                        log=lambda msg: None)
    return bm, spec

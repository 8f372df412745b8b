"""Serving launcher, offline mode: a static batch through the fused prefill
and lockstep decode, on the H100 by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 8 --prompt-len 128 --gen 32 --temperature 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu

Counterpart of the offline mode of ``repro/launch/serve.py``.  Weights are
random, made from ``--seed``; prefill and decode attention run on the Hopper
kernels (``repro_torch/kernels``).  Without CUDA it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.decode import decode_step, init_cache, prefill_cache
from repro_torch.models.transformer import RunCtx, init_params


def generators(seed: int, device) -> List[torch.Generator]:
    """One generator per use (init / prompts / sampling): a shared stream
    would correlate the sampling chain with the init."""
    seeds = [int(s.generate_state(1)[0])
             for s in np.random.SeedSequence(seed).spawn(3)]
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def setup(args):
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ctx = RunCtx(device=str(dev))
    g_init, g_prompt, g_sample = generators(args.seed, dev)
    params = init_params(g_init, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g_prompt, device=dev)
    return cfg, ctx, params, prompts, g_sample


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_offline(args) -> Dict[str, Any]:
    """Prefill a random batch of prompts, then decode ``args.gen`` tokens.

    Returns the prompts, the generated tokens (b, gen), the logits after
    prefill and after the last step, and the wall times of both phases.
    """
    cfg, ctx, params, prompts, g_sample = setup(args)
    dev = prompts.device
    pattern = cfg.pattern_for_long_context() if args.long_context else None
    cache_len = args.prompt_len + args.gen
    cache = init_cache(cfg, args.batch, cache_len, ctx, pattern=pattern)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_cache(params, prompts, cache, cfg, ctx,
                                  pattern=pattern)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    out = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=g_sample)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
        logits, cache = decode_step(params, cache, nxt[:, None], cfg, ctx,
                                    pattern=pattern)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(out, dim=1)
    print(f"arch={cfg.name} batch={args.batch} prefill={t_prefill:.3f}s "
          f"decode={t_decode:.3f}s "
          f"({args.batch * args.gen / t_decode:.1f} tok/s) "
          f"cache_len={cache_len} device={dev}")
    print("sample:", tokens[0, :16].tolist())
    return {"cfg": cfg, "prompts": prompts, "tokens": tokens,
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    run_offline(parse_args(argv))


if __name__ == "__main__":
    main()

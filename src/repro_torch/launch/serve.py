"""Serving launcher: offline batched decoding or streaming continuous
batching, on the H100 by default.

Offline (a static batch through the fused prefill and lockstep decode):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 8 --prompt-len 128 --gen 32 --temperature 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu

Streaming (continuous batching under Table I arrivals with per-request
deadlines: ``measured_cost_model``, then ``ContinuousBatchingServer`` over a
fixed-slot ``SlotRunner``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --streaming --dist S1 --horizon 8 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --streaming

Counterpart of ``repro/launch/serve.py``.  ``--arch`` takes any config of
the registry but the paper CNN (qwen2-0.5b, mixtral-8x22b,
recurrentgemma-2b, xlstm-125m, whisper-base, qwen2-vl-2b, ...):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --batch 8 --prompt-len 128 --gen 16 --temperature 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --reduced --device cpu

Weights are random, made from ``--seed``; so are whisper's encoder frames
(the stubbed front end's output, from a stream of their own), which
``prefill_cross_kv`` runs through the encoder before the prompt's prefill.
Prefill and decode attention run on the Hopper kernels
(``repro_torch/kernels``); the xLSTM blocks are plain PyTorch, as the
reference's are plain jnp.  Without CUDA it raises unless ``--device cpu``
is given.  Paged serving has no flags here, as in the reference: it is
reached through the ``SlotRunner``/``Scheduler`` API (``repro_torch.serve``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.decode import (decode_step, init_cache, prefill_cache,
                                       prefill_cross_kv)
from repro_torch.models.transformer import RunCtx, init_params


def generators(seed: int, device) -> List[torch.Generator]:
    """One generator per use (init / prompts / sampling / audio frames): a
    shared stream would correlate the sampling chain with the init.  Each
    is a ``SeedSequence.spawn`` child, which keeps its index, so adding the
    fourth left the first three's draws as they were."""
    seeds = [int(s.generate_state(1)[0])
             for s in np.random.SeedSequence(seed).spawn(4)]
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def setup(args, cfg=None):
    """(cfg, ctx, params, prompts, sampling generator) for ``args``.
    ``cfg`` replaces the registry's config of ``args.arch`` (a caller that
    serves a cut of a model, such as fewer layers, passes it here)."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    ctx = RunCtx(device=str(dev))
    g_init, g_prompt, g_sample, _ = generators(args.seed, dev)
    params = init_params(g_init, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g_prompt, device=dev)
    return cfg, ctx, params, prompts, g_sample


def audio_feats(args, cfg, device) -> torch.Tensor:
    """Whisper's encoder input for ``args.batch`` rows, (b, encoder_seq_len,
    d_model) f32 normal draws from the fourth generator: the stubbed conv
    front end's output, as the reference draws it from its own key."""
    g_audio = generators(args.seed, device)[3]
    return torch.randn((args.batch, cfg.encoder_seq_len, cfg.d_model),
                       generator=g_audio, device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_offline(args, cfg=None) -> Dict[str, Any]:
    """Prefill a random batch of prompts, then decode ``args.gen`` tokens.

    Returns the prompts, the generated tokens (b, gen), the logits after
    prefill and after the last step, and the wall times of both phases
    (for whisper also the encoder frames and the wall time of
    ``prefill_cross_kv``, which runs before the prefill and outside its
    time, as in the reference).  ``cfg``: as in :func:`setup`.
    """
    cfg, ctx, params, prompts, g_sample = setup(args, cfg)
    dev = prompts.device
    pattern = cfg.pattern_for_long_context() if args.long_context else None
    cache_len = args.prompt_len + args.gen
    cache = init_cache(cfg, args.batch, cache_len, ctx, pattern=pattern)
    feats, t_encode = None, 0.0
    if cfg.encoder_layers:
        feats = audio_feats(args, cfg, dev)
        _sync(dev)
        t0 = time.perf_counter()
        cache = prefill_cross_kv(params, feats, cfg, ctx, cache)
        _sync(dev)
        t_encode = time.perf_counter() - t0

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
    enc = f"encode={t_encode:.3f}s " if cfg.encoder_layers else ""
    print(f"arch={cfg.name} batch={args.batch} {enc}prefill={t_prefill:.3f}s "
          f"decode={t_decode:.3f}s "
          f"({args.batch * args.gen / t_decode:.1f} tok/s) "
          f"cache_len={cache_len} device={dev}")
    print("sample:", tokens[0, :16].tolist())
    return {"cfg": cfg, "prompts": prompts, "tokens": tokens,
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "audio_feats": feats, "encode_s": t_encode}


def run_streaming(args) -> Dict[str, Any]:
    """Continuous batching of a Table I request trace on the real model.

    Returns the request records, the summary, the cost model and the
    runner (its ``generated`` tokens by request id)."""
    from repro_torch.serve import (ContinuousBatchingServer, RequestStream,
                                   SlotRunner, measured_cost_model)
    cfg, ctx, params, _, _ = setup(args)
    pattern = cfg.pattern_for_long_context() if args.long_context else None
    cache_len = args.prompt_len + args.gen
    cost = measured_cost_model(params, cfg, ctx, args.max_batch, cache_len,
                               args.prompt_len, pattern=pattern)
    runner = SlotRunner(params, cfg, ctx, args.max_batch, cache_len,
                        pattern=pattern, temperature=args.temperature,
                        seed=args.seed)
    stream = RequestStream(dist=args.dist, n_clients=args.clients,
                           prompt_len=args.prompt_len,
                           max_new_tokens=args.gen,
                           slo_ttft_s=args.slo_ttft, seed=args.seed)
    requests = stream.generate(args.horizon)
    tracker = None
    if args.track:
        from repro_torch.obs import JsonTracker
        tracker = JsonTracker(
            args.track, seed=args.seed,
            meta={"entry": "repro_torch.launch.serve --streaming",
                  "arch": cfg.name, "dist": args.dist,
                  "clients": args.clients, "max_batch": args.max_batch,
                  "device": str(runner.device)})
    recs, summary = ContinuousBatchingServer(
        args.max_batch, cost, runner=runner, tracker=tracker).run(requests)
    if tracker is not None:
        tracker.finish()
        print(f"# run ledger -> {args.track}")
    print(f"arch={cfg.name} dist={args.dist} clients={args.clients} "
          f"requests={summary['n_requests']} "
          f"decode_step={cost.decode_step_s * 1e3:.3f}ms "
          f"prefill={cost.prefill_s(args.prompt_len) * 1e3:.3f}ms "
          f"device={runner.device}")
    for k in ("completed", "deadline_met", "dropped", "slo_attainment",
              "ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "tpot_p50_s",
              "throughput_tok_s", "goodput_tok_s"):
        v = summary[k]
        print(f"  {k} = {v:.4f}" if isinstance(v, float) else f"  {k} = {v}")
    done = [r for r in recs if r.completed]
    if done:
        print("sample:", runner.generated[done[0].rid][:16])
    return {"cfg": cfg, "records": recs, "summary": summary, "cost": cost,
            "runner": runner}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--offline", action="store_true",
                      help="static batch, fused prefill + lockstep decode "
                           "(default)")
    mode.add_argument("--streaming", action="store_true",
                      help="continuous batching under Table I arrivals")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    # streaming knobs
    ap.add_argument("--dist", default="S1", help="Table I distribution")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--horizon", type=float, default=8.0,
                    help="arrival window (sim seconds)")
    ap.add_argument("--slo-ttft", type=float, default=0.75)
    ap.add_argument("--track", metavar="LEDGER",
                    help="write a JSONL run ledger (request lifecycle events "
                         "+ scorecard) to this path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.streaming:
        run_streaming(args)
    else:
        run_offline(args)


if __name__ == "__main__":
    main()

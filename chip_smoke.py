#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX or of the ``repro``
package.  Phases, each fatal on failure (exit code 1, no result line):

1. require CUDA and print the card's name and power limit (nvidia-smi);
2. build every kernel of the serving path from ``src/repro_torch/csrc``,
   one nvcc per source, all started together;
3. turn TF32 off for matmuls and cuDNN, so f32 means f32 on both sides;
4. hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at awkward ones (masks, offsets, ragged
   lengths, mixed-age kv_len, f32 and bf16), each within a stated bound;
5. serve qwen2-0.5b offline at full width (random f32 weights from a seed,
   batch 8, prompt 128, 32 greedy tokens) through ``repro_torch.launch.
   serve.run_offline``, with the launch counters set to 0 just before and
   read just after; check they show 24 prefill and 24 x 32 decode launches,
   and hold the logits after prefill and after the last step against the
   same run on the plain versions (``backend="torch"``), teacher-forced;
6. drive the continuous-batching path (``init_slot_cache`` /
   ``slot_insert`` / ``slot_evict``) with requests of different prompt
   lengths, so per-slot kv_len reaches ``flash_decode``, counted the same
   way and held against the plain versions;
7. time each kernel's device work (CUDA events around calls queued ahead
   of the card) beside its plain version, its bound and one
   ``scaled_dot_product_attention`` call on the same inputs, a yardstick
   the port never makes; time prefill and decode steps (host clock around
   synchronised work), a decode step's device time the same way as the
   kernels', and, where torch.profiler records the card, its device time
   by kernel;
8. print one JSON line of kernels, then the result line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": 1}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# bounds of kernel vs plain version on the card: the reference's own oracle
# tolerances (tests/test_kernels_flash.py); both sides keep f32 statistics
# and differ in summation order (and, for bf16 decode, in the plain version's
# bf16 cast of p before PV)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# full-width logits, kernel path vs plain path: f32 through 24 layers whose
# attention sums run in different orders
LOGIT_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 CUDA-core and
# bf16 tensor-core operations/s
HBM_BPS = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

DEVICE = "cuda"
SERVE_ARGV = ["--arch", "qwen2-0.5b", "--batch", "8", "--prompt-len", "128",
              "--gen", "32", "--temperature", "0", "--seed", "0",
              "--device", DEVICE]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-3: card, build, numerics


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed no card")
    return out[0].strip()


def build(build_mod) -> None:
    t0 = time.perf_counter()
    libs = build_mod.build_all(["flash_attention", "flash_decode"])
    log(f"# built {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s")
    for lib in libs:
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"#   {lib.name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 4: kernels vs plain versions


def rand(torch, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def compare(torch, name, out, ref, dtype_name, errs):
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"{name}: kernel gave {tuple(out.shape)} {out.dtype}, plain "
             f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    tol = TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= tol + tol * ref.float().abs()).all())
    log(f"  {name}: max_abs_err={err:.3e} bound={tol:g} (rtol=atol) "
        f"{'ok' if ok else 'OVER'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    errs.append((dtype_name, err))


def check_kernels(torch, fa, fd):
    """Each kernel vs its plain version; returns max f32 error per kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    attn_cases = [
        # (label, b, sq, sk, h, kv, hd, kind, window, q_offset, dtype)
        ("serving prefill", 8, 128, 128, 14, 2, 64, "causal", 0, 0, "float32"),
        ("serving prefill", 8, 128, 128, 14, 2, 64, "causal", 0, 0, "bfloat16"),
        ("swa+q_offset", 2, 96, 128, 14, 2, 64, "swa", 48, 32, "float32"),
        ("causal+q_offset", 2, 24, 40, 4, 2, 64, "causal", 0, 16, "float32"),
        ("bidir ragged", 2, 100, 100, 8, 2, 128, "bidir", 0, 0, "float32"),
        ("causal ragged", 1, 100, 100, 14, 2, 64, "causal", 0, 0, "bfloat16"),
        ("swa hd256", 1, 150, 150, 10, 1, 256, "swa", 64, 0, "float32"),
        ("causal hd32 mha", 2, 256, 256, 4, 4, 32, "causal", 0, 0, "float32"),
    ]
    errs = {"flash_attention": [], "flash_decode": []}
    log("# phase 4: kernels vs plain versions")
    for (label, b, sq, sk, h, kv, hd, kind, window, off, dt) in attn_cases:
        q = rand(torch, (b, sq, h, hd), dts[dt], gen)
        k = rand(torch, (b, sk, kv, hd), dts[dt], gen)
        v = rand(torch, (b, sk, kv, hd), dts[dt], gen)
        out = fa.flash_attention(q, k, v, kind=kind, window=window,
                                 q_offset=off)
        ref = fa.flash_attention_ref(q, k, v, kind=kind, window=window,
                                     q_offset=off)
        compare(torch, f"flash_attention {label} q{(b, sq, h, hd)} "
                f"k{(b, sk, kv, hd)} {kind} w={window} off={off} {dt}",
                out, ref, dt, errs["flash_attention"])
    dec_cases = [
        # (label, b, S, h, kv, hd, kv_len, dtype)
        ("serving decode, lockstep", 8, 160, 14, 2, 64, 129, "float32"),
        ("serving decode, mixed age", 8, 160, 14, 2, 64,
         [1, 17, 64, 65, 100, 128, 159, 160], "float32"),
        ("serving decode, mixed age", 8, 160, 14, 2, 64,
         [1, 17, 64, 65, 100, 128, 159, 160], "bfloat16"),
        ("ragged S, out-of-range lens", 8, 100, 14, 2, 64,
         [0, 1, 37, 64, 65, 99, 100, 250], "float32"),
        ("hd128 g6", 3, 77, 48, 8, 128, [77, 5, 40], "float32"),
        ("hd256 g10", 2, 64, 10, 1, 256, [64, 33], "float32"),
        ("hd32 g1", 2, 50, 4, 4, 32, [50, 9], "bfloat16"),
    ]
    for (label, b, S, h, kv, hd, lens, dt) in dec_cases:
        q = rand(torch, (b, 1, h, hd), dts[dt], gen)
        kc = rand(torch, (b, S, kv, hd), dts[dt], gen)
        vc = rand(torch, (b, S, kv, hd), dts[dt], gen)
        kvl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        out = fd.flash_decode(q, kc, vc, kvl)
        ref = fd.flash_decode_ref(q, kc, vc, kvl)
        compare(torch, f"flash_decode {label} q{(b, 1, h, hd)} "
                f"cache{(b, S, kv, hd)} kv_len={lens} {dt}", out, ref, dt,
                errs["flash_decode"])
    return {name: max(e for d, e in es if d == "float32")
            for name, es in errs.items()}


# ---------------------------------------------------------------------------
# phase 5-6: the serving paths


def counts(fa, fd):
    return {"flash_attention": fa.launches, "flash_decode": fd.launches}


def reset(fa, fd):
    fa.launches = 0
    fd.launches = 0


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def serve_offline(torch, fa, fd, serve, dec):
    log("# phase 5: offline serving, qwen2-0.5b full width")
    args = serve.parse_args(SERVE_ARGV)
    reset(fa, fd)
    res = serve.run_offline(args)
    torch.cuda.synchronize()
    launched = counts(fa, fd)
    cfg = res["cfg"]
    n_layers, gen = cfg.num_layers, args.gen
    log(f"  launches on the offline path: {launched}")
    want = {"flash_attention": n_layers, "flash_decode": n_layers * gen}
    if launched != want:
        fail(f"offline path launched {launched}, expected {want}")
    for key in ("prefill_logits", "last_logits"):
        if not torch.isfinite(res[key]).all():
            fail(f"offline {key} not finite")
    if res["tokens"].shape != (args.batch, gen):
        fail(f"tokens shape {tuple(res['tokens'].shape)}")

    # the same run on the plain versions, teacher-forced with its tokens
    cfg, ctx, params, prompts, _ = serve.setup(args)
    if not torch.equal(prompts, res["prompts"]):
        fail("prompts differ between two setups from one seed")
    tctx = dataclasses.replace(ctx, prefill_backend="torch",
                               decode_backend="torch")
    cache = dec.init_cache(cfg, args.batch, args.prompt_len + gen, tctx)
    logits, cache = dec.prefill_cache(params, prompts, cache, cfg, tctx)
    err_prefill = max_err(res["prefill_logits"], logits)
    agree = 0
    for i in range(gen):
        logits, cache = dec.decode_step(params, cache,
                                        res["tokens"][:, i:i + 1], cfg, tctx)
        if i + 1 < gen:
            agree += int((torch.argmax(logits, -1)
                          == res["tokens"][:, i + 1]).sum())
    err_last = max_err(res["last_logits"], logits)
    scale = float(logits.abs().max())
    log(f"  logits vs plain path: after prefill max_abs_err={err_prefill:.3e}"
        f", after step {gen} max_abs_err={err_last:.3e} (|logits| max "
        f"{scale:.3f}), bound {LOGIT_TOL:g}; greedy tokens agree "
        f"{agree}/{args.batch * (gen - 1)}")
    if not (err_prefill <= LOGIT_TOL and err_last <= LOGIT_TOL):
        fail("offline logits disagree with the plain path")
    del params, cache
    return launched, res


def serve_slots(torch, fa, fd, serve, dec):
    log("# phase 6: continuous batching, per-slot kv_len")
    args = serve.parse_args(SERVE_ARGV)
    cfg, ctx, params, _, _ = serve.setup(args)
    tctx = dataclasses.replace(ctx, prefill_backend="torch",
                               decode_backend="torch")
    max_batch, cache_len, steps = 4, 160, 12
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    prompts = {plen: torch.randint(0, cfg.vocab_size, (1, plen),
                                   generator=gen, device=DEVICE)
               for plen in (17, 64, 100, 128, 33)}

    def admit(cache, run_ctx, slot, plen):
        fresh = dec.init_cache(cfg, 1, cache_len, run_ctx)
        _, src = dec.prefill_cache(params, prompts[plen], fresh, cfg, run_ctx)
        return dec.slot_insert(cache, slot, src)

    def run(run_ctx, forced=None):
        cache = dec.init_slot_cache(cfg, max_batch, cache_len, run_ctx)
        for slot, plen in enumerate((17, 64, 100, 128)):
            cache = admit(cache, run_ctx, slot, plen)
        tok = torch.zeros((max_batch, 1), dtype=torch.long, device=DEVICE)
        toks, logits_all = [], []
        for i in range(steps):
            if forced is not None:
                tok = forced[i]
            toks.append(tok)
            logits, cache = dec.decode_step(params, cache, tok, cfg, run_ctx)
            logits_all.append(logits)
            tok = torch.argmax(logits, -1)[:, None]
            if i == 5:  # slot 2 finishes; a new request takes it over
                cache = dec.slot_evict(cache, 2)
                cache = admit(cache, run_ctx, 2, 33)
        return toks, logits_all, cache

    reset(fa, fd)
    toks, logits_k, cache = run(ctx)
    torch.cuda.synchronize()
    launched = counts(fa, fd)
    want = {"flash_attention": 5 * cfg.num_layers,
            "flash_decode": steps * cfg.num_layers}
    log(f"  launches on the slot path: {launched}; final per-slot pos "
        f"{cache['pos'].tolist()}")
    if launched != want:
        fail(f"slot path launched {launched}, expected {want}")
    _, logits_t, _ = run(tctx, forced=toks)
    err = max(max_err(a, b) for a, b in zip(logits_k, logits_t))
    log(f"  slot-path logits vs plain path: max_abs_err={err:.3e} "
        f"bound {LOGIT_TOL:g}")
    if not err <= LOGIT_TOL:
        fail("slot-path logits disagree with the plain path")
    return launched


# ---------------------------------------------------------------------------
# phase 7: timing


def _device_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def profiled(torch, fn, iters):
    """Run ``fn`` ``iters`` times under torch.profiler (CPU + CUDA);
    returns the key_averages."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def queued_ms(torch, fn, iters, max_cycles=1 << 34):
    """Device time of one call, or None: CUDA events around ``iters`` calls
    that the host queued while the card still slept on a spin kernel, so no
    host gap between launches falls inside the interval.  The sleep grows
    until the card is still asleep once every call is queued; None if it
    never is (a call that syncs, or more launches than the queue holds)."""
    torch.cuda.synchronize()
    cycles = 1 << 24
    while cycles <= max_cycles:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles <<= 2
    return None


def device_ms(torch, fn, iters=20):
    """Device time of one call (see :func:`queued_ms`), after warm-up."""
    for _ in range(3):
        fn()
    ms = queued_ms(torch, fn, iters)
    if ms is None:
        fail("could not queue the timed calls ahead of the card")
    return ms


def call_ms(torch, fn, iters=50):
    """Wall time of one call in a back-to-back loop (CUDA events): the
    larger of the device time and the host's time to issue the call."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, dtype_name: str):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_fns(torch, kernel, plain, library):
    return {"ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, iters=5),
            "library_ms": device_ms(torch, library),
            "call_ms": call_ms(torch, kernel)}


def time_kernels(torch, fa, fd):
    """Kernel, plain and library device times at the serving path's shapes:
    the prefill of the offline run and its last decode step."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    b, s, h, kv, hd = 8, 128, 14, 2, 64
    q = torch.randn((b, s, h, hd), generator=gen, device=DEVICE)
    k = torch.randn((b, s, kv, hd), generator=gen, device=DEVICE)
    v = torch.randn((b, s, kv, hd), generator=gen, device=DEVICE)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    attn = time_fns(
        torch, lambda: fa.flash_attention(q, k, v),
        lambda: fa.flash_attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True))
    pairs = b * h * s * (s + 1) // 2          # unmasked (query, key) pairs
    attn["bound_ms"], attn["bound_by"] = bound(
        4 * (2 * q.numel() + k.numel() + v.numel()), 4 * hd * pairs,
        "float32")

    S, kv_len = 160, 160                       # the last offline step
    qd = torch.randn((b, 1, h, hd), generator=gen, device=DEVICE)
    kc = torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
    vc = torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
    kvl = torch.full((b,), kv_len, dtype=torch.int32, device=DEVICE)
    qdt, kct, vct = (x.transpose(1, 2).contiguous() for x in (qd, kc, vc))
    dec = time_fns(
        torch, lambda: fd.flash_decode(qd, kc, vc, kvl),
        lambda: fd.flash_decode_ref(qd, kc, vc, kvl),
        lambda: F.scaled_dot_product_attention(qdt, kct, vct,
                                               enable_gqa=True))
    dec["bound_ms"], dec["bound_by"] = bound(
        4 * (2 * qd.numel() + 2 * b * kv_len * kv * hd) + 4 * b,
        4 * hd * b * h * kv_len, "float32")
    return {"flash_attention": attn, "flash_decode": dec}


def profile_decode(torch, dec, params, prompts, cfg, ctx, cache_len, card,
                   step_ms, steps=4, top=8):
    """Where a decode step's time goes: its device time (CUDA events, the
    step queued ahead of the card) against ``step_ms`` of wall time, then
    torch.profiler's device time by kernel, where it records the card, and
    host time by op."""
    cache = dec.init_cache(cfg, prompts.shape[0], cache_len, ctx)
    logits, cache = dec.prefill_cache(params, prompts, cache, cfg, ctx)
    state = {"logits": logits, "cache": cache}

    def step():
        nxt = torch.argmax(state["logits"], -1)[:, None]
        state["logits"], state["cache"] = dec.decode_step(
            params, state["cache"], nxt, cfg, ctx)

    step()
    busy = queued_ms(torch, step, 1, max_cycles=1 << 32)
    if busy is None:
        log("  decode step device time: not measured (its launches could "
            "not all be queued ahead of the card)")
    else:
        log(f"  decode step: device {busy:.3f} ms of {step_ms:.3f} ms wall, "
            f"idle {100 - 100 * busy / step_ms:.1f}%  [{card}]")
    events = profiled(torch, step, steps)
    dev = [e for e in events if _on_device(e)]
    kernel_ms = sum(_device_us(e) for e in dev) / steps / 1e3
    if kernel_ms <= 0:
        log("  torch.profiler recorded no device time: device time by "
            "kernel not measured")
    else:
        log(f"  decode step: kernels {kernel_ms:.3f} ms (torch.profiler, "
            f"gaps excluded) of {step_ms:.3f} ms wall, idle "
            f"{100 - 100 * kernel_ms / step_ms:.1f}%  [{card}]")
        log(f"  device time by kernel (torch.profiler, {steps} steps):")
    for e in sorted(dev, key=_device_us, reverse=True)[:top]:
        log(f"    {_device_us(e) / steps:9.1f} us/step {e.count // steps:5d}x"
            f"  {e.key[:80]}")
    log("  host time by op (self, under torch.profiler):")
    host = [e for e in events if not _on_device(e)]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]:
        log(f"    {e.self_cpu_time_total / steps:9.1f} us/step "
            f"{e.count // steps:5d}x  {e.key[:80]}")


def time_serving(torch, serve, dec, card):
    log(f"# phase 7: serving times on {card}")
    args = serve.parse_args(SERVE_ARGV)
    cfg, ctx, params, prompts, _ = serve.setup(args)
    cache_len = args.prompt_len + args.gen

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    prefill_s = []
    for _ in range(4):
        cache = dec.init_cache(cfg, args.batch, cache_len, ctx)
        t, (logits, cache) = sync_time(
            lambda: dec.prefill_cache(params, prompts, cache, cfg, ctx))
        prefill_s.append(t)

    def decode_all():
        nonlocal logits, cache
        for _ in range(args.gen):
            nxt = torch.argmax(logits, -1)[:, None]
            logits, cache = dec.decode_step(params, cache, nxt, cfg, ctx)
        return logits

    decode_s, _ = sync_time(decode_all)
    p_ms = sorted(prefill_s[1:])[1] * 1e3      # median of the warm runs
    step_ms = decode_s / args.gen * 1e3
    tok_s = args.batch * args.gen / decode_s
    log(f"  prefill (b={args.batch}, prompt {args.prompt_len}): "
        f"{p_ms:.3f} ms  [{card}]")
    log(f"  decode: {step_ms:.3f} ms/step, {tok_s:.1f} tokens/s  [{card}]")
    log(f"  end to end: {args.batch * args.gen / (p_ms / 1e3 + decode_s):.1f}"
        f" generated tokens/s incl. prefill  [{card}]")
    profile_decode(torch, dec, params, prompts, cfg, ctx, cache_len, card,
                   step_ms)


# ---------------------------------------------------------------------------


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")

    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.device_count()} device(s), "
        f"using {kind}")

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve
    from repro_torch.models import decode as dec

    build(_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    errs = check_kernels(torch, fa, fd)
    launched, _ = serve_offline(torch, fa, fd, serve, dec)
    serve_slots(torch, fa, fd, serve, dec)
    times = time_kernels(torch, fa, fd)
    time_serving(torch, serve, dec, card)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:86"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:148")}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = times[name]
        log(f"  {name}: device {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, sdpa {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}); {t.pop('call_ms'):.4f} ms per call issued "
            f"back to back  [{card}]")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launched[name],
                        "max_abs_err": errs[name], **t})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

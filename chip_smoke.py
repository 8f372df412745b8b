#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX or of the ``repro``
package.  Phases, each fatal on failure (exit code 1, no result line):

1. require CUDA and print the card's name and power limit (nvidia-smi);
2. build every kernel of the serving and training paths from
   ``src/repro_torch/csrc``, one nvcc per source, all started together;
3. turn TF32 off for matmuls and cuDNN, so f32 means f32 on both sides;
4. hold each attention kernel against its plain PyTorch version on the
   card, at the serving path's shapes and at awkward ones (masks, offsets,
   ragged lengths, mixed-age kv_len, f32 and bf16), each within a bound;
   ``flash_decode_paged`` also at pages of 1, 5 and 128 tokens, shared and
   scratch-row tables, kv_len 0/1/full, and bit-identical to
   ``flash_decode`` on the gathered view;
5. hold the training kernels against their plain versions: ``block_topk``
   (f32 and bf16, three shapes, k at 1/10/90 % of the block, an all-zero
   and an all-ones row) and ``scatter_aggregate`` (16 packets with 2- and
   4-way duplicates, and one packet at qwen2-0.5b's full gradient length)
   bit for bit, ``fused_sgdm`` (odd n, aligned and not, momentum 0 and
   0.9, weight decay 0 and 0.01) within rtol 1e-4, atol 1e-7;
6. serve qwen2-0.5b offline at full width (random f32 weights from a seed,
   batch 8, prompt 128, 32 greedy tokens) through ``repro_torch.launch.
   serve.run_offline``, with the launch counters set to 0 just before and
   read just after; check they show 24 prefill and 24 x 32 decode launches,
   and hold the logits after prefill and after the last step against the
   same run on the plain versions (``backend="torch"``), teacher-forced;
7. drive the continuous-batching path (``init_slot_cache`` /
   ``slot_insert`` / ``slot_evict``) with requests of different prompt
   lengths, so per-slot kv_len reaches ``flash_decode``, counted the same
   way and held against the plain versions;
   7b. the same on a paged cache (``init_paged_cache``, pages of 16 from a
   ``PagePool``, an eviction whose pages are recycled into a new request):
   12 x 24 ``flash_decode_paged`` launches and no ``flash_decode``; logits
   bit-identical to the fixed-slot kernel path at the same occupancy and
   within LOGIT_TOL of the paged plain path;
   7c. paged serving behind the ``Scheduler`` (``SlotRunner`` with 8 slots,
   pages of 16, chunked prefill of 64, decode_first, a fixed cost model) on
   a Table I trace with two shared-prefix templates: sharing off, sharing
   on and a fixed-slot runner; conservation on every run, launches equal to
   prefill chunks x 24 and decode steps x 24, paged tokens identical to
   fixed-slot tokens, prefix hits with sharing on;
   7d. the streaming launcher (``run_streaming``: ``measured_cost_model``,
   then ``ContinuousBatchingServer`` over a fixed-slot ``SlotRunner``) on a
   short Table I trace, counted the same way: launches equal to fused
   prefills x 24 and decode steps x 24, every request in one terminal
   state, completed requests with all their tokens;
8. train qwen2-0.5b at full width and depth (random f32 weights from seed
   0, batch 8 x 256 tokens from ``TokenData``, remat, loss chunk 128) with
   ``make_ddp_steps`` (cr 0.1, momentum-SGD 0.9, lr 1e-3, one rank): a
   dense step, then two compressed steps, then
   ``AdaptiveCompressor(use_block_topk=True).step`` on the new gradient,
   with the counters set to 0 just before and read just after; check one
   ``fused_sgdm`` per parameter leaf per step, one ``scatter_aggregate``
   per compressed step and one ``block_topk``; run the same steps from
   the same start on the plain path (plain ``fused_sgdm``, the
   ``index_put_`` chain) and hold loss, gap and params against it;
9. time each kernel's device work (CUDA events around calls queued ahead
   of the card) beside its plain version, its bound and one PyTorch call
   on the same inputs (``scaled_dot_product_attention``, ``torch.topk``
   per block, ``torch._fused_sgd_``, ``index_put_``), a yardstick the port
   never makes; time prefill and decode steps (host clock around
   synchronised work), a decode step's device time the same way as the
   kernels', and, where torch.profiler records the card, its device time
   by kernel; time the dense and compressed training steps with CUDA-event
   splits (forward+backward, top-k, aggregation, update); time a decode
   step of a paged and of a fixed-slot cache at one occupancy, in turns,
   and ``measured_cost_model``;
10. print one JSON line of kernels, then the result line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": 1}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import types
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
# fused_sgdm vs its plain version: the reference's oracle bound
# (tests/test_kernels.py); block_topk and scatter_aggregate must match bit
# for bit (the reference pins both exact)
SGDM_RTOL, SGDM_ATOL = 1e-4, 1e-7
# full-width training, kernel path vs plain path: both run the same forward
# and backward, and the kernels repeat their plain versions' roundings, so
# these leave room only for a library reduction that changes its order
TRAIN_TOL = {"loss_rel": 1e-6, "gap_abs": 1e-6, "param_abs": 1e-6}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 CUDA-core and
# bf16 tensor-core operations/s
HBM_BPS = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

DEVICE = "cuda"
# phase 7c: paged serving behind the Scheduler (a fixed cost model, so the
# schedule is deterministic; SLOs generous enough that nothing is shed)
SCHED = {"max_batch": 8, "cache_len": 192, "chunk": 64, "horizon": 1.75,
         "paged": {"page_size": 16, "num_pages": 72},
         "cost": {"decode_step_s": 0.02, "prefill_token_s": 2e-4,
                  "prefill_base_s": 2e-3},
         "stream": {"dist": "S1", "prompt_lens": (17, 64, 128),
                    "max_new_tokens": 32, "slo_ttft_s": 1e3,
                    "slo_tpot_s": 1e3, "n_templates": 2,
                    "template_prefix_len": 48, "seed": 0}}
SERVE_ARGV = ["--arch", "qwen2-0.5b", "--batch", "8", "--prompt-len", "128",
              "--gen", "32", "--temperature", "0", "--seed", "0",
              "--device", DEVICE]
# phase 7d: the streaming launcher on a short Table I trace (about ten
# requests over eight slots)
STREAM_ARGV = ["--streaming", "--dist", "S1", "--clients", "16",
               "--max-batch", "8", "--horizon", "2"]
TRAIN = {"arch": "qwen2-0.5b", "batch": 8, "seq": 256, "loss_chunk": 128,
         "cr": 0.1, "momentum": 0.9, "lr": 1e-3, "seed": 0}
KERNEL_SOURCES = ["flash_attention", "flash_decode", "block_topk",
                  "fused_sgdm", "scatter_agg"]
KERNEL_NAMES = ("flash_attention", "flash_decode", "flash_decode_paged",
                "block_topk", "fused_sgdm", "scatter_aggregate")


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
    libs = build_mod.build_all(KERNEL_SOURCES)
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
    errs["flash_decode_paged"] = check_paged(torch, fd, gen, dts)
    return {name: max(e for d, e in es if d == "float32")
            for name, es in errs.items()}


def block_table(torch, kind, b, ncols, rows, gen):
    """(b, ncols) int32 pool rows: "scrambled" draws every row once before
    any twice; "shared" gives slots 0 and 1 the same first half; "scratch"
    points the last slot's whole row at the pool's top row."""
    n = b * ncols
    perm = torch.cat([torch.randperm(rows, generator=gen, device=DEVICE)
                      for _ in range(-(-n // rows))])[:n]
    bt = perm.reshape(b, ncols).to(torch.int32)
    if kind == "shared":
        bt[1, :ncols // 2] = bt[0, :ncols // 2]
    elif kind == "scratch":
        bt[-1] = rows - 1
    return bt.contiguous()


def check_paged(torch, fd, gen, dts):
    """``flash_decode_paged`` vs its plain version (the ``pool[bt]`` gather,
    then ``flash_decode_ref``), and bit for bit vs ``flash_decode`` on the
    gathered view: the two share one kernel body and tile order."""
    cases = [
        # (label, b, pg, ncols, rows, h, kv, hd, kv_len, dtype, table)
        ("serving decode", 8, 16, 12, 80, 14, 2, 64, [160] * 8, "float32",
         "scrambled"),
        ("serving decode, mixed age", 8, 16, 12, 80, 14, 2, 64,
         [1, 17, 64, 65, 100, 128, 159, 192], "bfloat16", "scrambled"),
        ("page 1", 3, 1, 40, 130, 14, 2, 64, [40, 1, 17], "float32",
         "scrambled"),
        ("page 5, kv_len 0", 4, 5, 13, 60, 14, 2, 64, [0, 1, 65, 33],
         "float32", "scrambled"),
        ("page 128 > tile", 2, 128, 3, 7, 14, 2, 64, [384, 200], "float32",
         "scrambled"),
        ("two slots share rows", 4, 16, 6, 20, 14, 2, 64, [90, 70, 96, 5],
         "float32", "shared"),
        ("slot on the top scratch row", 3, 16, 4, 10, 14, 2, 64,
         [64, 30, 1], "float32", "scratch"),
        ("g 1, hd 32", 2, 16, 4, 9, 4, 4, 32, [64, 20], "float32",
         "scrambled"),
        ("hd 128, g 4", 3, 8, 10, 40, 8, 2, 128, [80, 41, 7], "float32",
         "scrambled"),
    ]
    errs = []
    for (label, b, pg, ncols, rows, h, kv, hd, lens, dt, table) in cases:
        q = rand(torch, (b, 1, h, hd), dts[dt], gen)
        kp = rand(torch, (rows, pg, kv, hd), dts[dt], gen)
        vp = rand(torch, (rows, pg, kv, hd), dts[dt], gen)
        bt = block_table(torch, table, b, ncols, rows, gen)
        kvl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        out = fd.flash_decode_paged(q, kp, vp, bt, kvl)
        ref = fd.flash_decode_paged_ref(q, kp, vp, bt, kvl)
        compare(torch, f"flash_decode_paged {label} q{(b, 1, h, hd)} "
                f"pools{(rows, pg, kv, hd)} bt{(b, ncols)} {table} "
                f"kv_len={lens} {dt}", out, ref, dt, errs)
        S = ncols * pg
        view = [pool[bt.long()].reshape(b, S, kv, hd) for pool in (kp, vp)]
        same = torch.equal(out, fd.flash_decode(q, *view, kvl))
        log(f"    bit-identical to flash_decode on the gathered view: "
            f"{same}")
        if not same:
            fail("flash_decode_paged differs from flash_decode on the same "
                 "keys")
    return errs


# ---------------------------------------------------------------------------
# phase 5: training kernels vs plain versions


def same_bits(torch, a, b) -> bool:
    """Equal shapes, dtypes and bit patterns (so -0.0 differs from 0.0)."""
    width = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(width), b.view(width)))


def packets(torch, D, k, n, gen):
    """D packets of k indices, unique in a packet: a quarter of each
    packet is shared by a group of 4 packets, another quarter by a pair,
    the rest its own, all drawn disjoint from one permutation of n."""
    q = k // 4
    perm = torch.randperm(n, generator=gen, device=DEVICE)
    groups = perm[:D // 4 * q].reshape(D // 4, q)
    pairs = perm[D // 4 * q:D // 4 * q + D // 2 * q].reshape(D // 2, q)
    own = perm[D // 4 * q + D // 2 * q:][:D * (k - 2 * q)].reshape(D, -1)
    idx = torch.stack([torch.cat([groups[d // 4], pairs[d // 2], own[d]])
                       for d in range(D)])
    order = torch.argsort(torch.rand((D, k), generator=gen, device=DEVICE),
                          dim=1)
    idx = torch.gather(idx, 1, order).to(torch.int32)
    vals = torch.randn((D, k), generator=gen, device=DEVICE) * 1e3
    vals[:, 0] = -0.0
    return vals, idx


def check_train_kernels(torch, bt, sa, n_full):
    """block_topk and scatter_aggregate bit for bit, fused_sgdm within
    (SGDM_RTOL, SGDM_ATOL); returns the max abs error per kernel."""
    log("# phase 5: training kernels vs plain versions")
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errs = {}
    for dt in dts:
        for rows, bs in ((8, 128), (24, 256), (4096, 1024)):
            g = rand(torch, (rows, bs), dts[dt], gen)
            g[0] = 0
            g[1] = 1
            for frac in (0.01, 0.1, 0.9):
                k = max(1, int(frac * bs))
                out, cnt = bt.block_topk(g, k)
                ref, rcnt = bt.block_topk_ref(g, k)
                torch.cuda.synchronize()
                ok = same_bits(torch, out, ref) and torch.equal(cnt, rcnt)
                zero_one = (int(cnt[0, 0]), int(cnt[1, 0]))
                log(f"  block_topk ({rows}, {bs}) k={k} {dt}: "
                    f"{'bit-exact' if ok else 'DIFFERS'}, counts equal "
                    f"{torch.equal(cnt, rcnt)}, zero/ones rows keep "
                    f"{zero_one}, mean count {cnt.float().mean():.2f}")
                if not ok or zero_one != (0, bs):
                    fail("block_topk disagrees with its plain version")
    errs["block_topk"] = 0.0

    worst = 0.0
    for off in (0, 1):                 # 16-byte aligned, and not
        n = 1_000_003 - off
        base = [torch.randn(1_000_003, generator=gen, device=DEVICE)
                for _ in range(3)]
        p, m, g = (t[off:] for t in base)
        lr = torch.tensor(1e-3, device=DEVICE)
        for mu in (0.0, 0.9):
            for wd in (0.0, 0.01):
                pk, mk = bt.fused_sgdm(p, m, g, lr, mu, wd)
                pr, mr = bt.fused_sgdm_ref(p, m, g, lr, mu, wd)
                torch.cuda.synchronize()
                err = max(max_err(pk, pr), max_err(mk, mr))
                ok = all(bool(((a - b).abs() <= SGDM_ATOL
                               + SGDM_RTOL * b.abs()).all())
                         for a, b in ((pk, pr), (mk, mr)))
                exact = same_bits(torch, pk, pr) and same_bits(torch, mk, mr)
                log(f"  fused_sgdm n={n} offset={off} mu={mu} wd={wd}: "
                    f"max_abs_err={err:.3e} (rtol {SGDM_RTOL:g}, atol "
                    f"{SGDM_ATOL:g}) {'ok' if ok else 'OVER'}"
                    f"{', bit-exact' if exact else ''}")
                if not ok:
                    fail("fused_sgdm disagrees with its plain version")
                worst = max(worst, err)
    errs["fused_sgdm"] = worst

    for D, k, n in ((16, 100_000, 2_000_003), (1, n_full // 10, n_full)):
        if D == 1:
            idx = (torch.randperm(k, generator=gen, device=DEVICE)
                   * (n // k)).to(torch.int32)[None]
            vals = torch.randn((1, k), generator=gen, device=DEVICE)
        else:
            vals, idx = packets(torch, D, k, n, gen)
        out = sa.scatter_aggregate(vals, idx, n)
        ref = sa.scatter_aggregate_ref(vals, idx, n)
        torch.cuda.synchronize()
        ok = same_bits(torch, out, ref)
        shared = k * D - int(torch.unique(idx).numel())
        log(f"  scatter_aggregate D={D} k={k} n={n} ({shared} repeated "
            f"entries): {'bit-exact' if ok else 'DIFFERS'}, max_abs_err="
            f"{max_err(out, ref):.3e}")
        if not ok:
            fail("scatter_aggregate disagrees with its plain version")
        del out, ref, vals, idx
    errs["scatter_aggregate"] = 0.0
    return errs


# ---------------------------------------------------------------------------
# phase 6-7: the serving paths


def counts(mods):
    """Launches of every kernel wrapper so far."""
    return {"flash_attention": mods.fa.launches,
            "flash_decode": mods.fd.launches,
            "flash_decode_paged": mods.fd.paged_launches,
            "block_topk": mods.bt.launches["block_topk"],
            "fused_sgdm": mods.bt.launches["fused_sgdm"],
            "scatter_aggregate": mods.sa.launches}


def reset(mods):
    mods.fa.launches = mods.fd.launches = mods.sa.launches = 0
    mods.fd.paged_launches = 0
    for key in mods.bt.launches:
        mods.bt.launches[key] = 0


def expect(**launched):
    """Launch counts for every kernel: the ones named, 0 for the rest."""
    return {name: launched.get(name, 0) for name in KERNEL_NAMES}


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def serve_offline(torch, mods, serve, dec):
    log("# phase 6: offline serving, qwen2-0.5b full width")
    args = serve.parse_args(SERVE_ARGV)
    reset(mods)
    res = serve.run_offline(args)
    torch.cuda.synchronize()
    launched = counts(mods)
    cfg = res["cfg"]
    n_layers, gen = cfg.num_layers, args.gen
    log(f"  launches on the offline path: {launched}")
    want = expect(flash_attention=n_layers, flash_decode=n_layers * gen)
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


def serve_slots(torch, mods, serve, dec):
    log("# phase 7: continuous batching, per-slot kv_len")
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

    reset(mods)
    toks, logits_k, cache = run(ctx)
    torch.cuda.synchronize()
    launched = counts(mods)
    want = expect(flash_attention=5 * cfg.num_layers,
                  flash_decode=steps * cfg.num_layers)
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


def serve_paged(torch, mods, serve, dec, paging):
    """Phase 7b: the slot run of phase 7 on a paged cache, teacher-forced
    against the fixed-slot kernel path and the paged plain path."""
    log("# phase 7b: paged decode, qwen2-0.5b full width")
    args = serve.parse_args(SERVE_ARGV)
    cfg, ctx, params, _, _ = serve.setup(args)
    tctx = dataclasses.replace(ctx, prefill_backend="torch",
                               decode_backend="torch")
    max_batch, cache_len, steps, page, n_pages = 5, 160, 12, 16, 64
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    prompts = {plen: torch.randint(0, cfg.vocab_size, (1, plen),
                                   generator=gen, device=DEVICE)
               for plen in (17, 64, 100, 128, 33)}

    def run(run_ctx, paged, forced=None):
        if paged:
            cache = dec.init_paged_cache(cfg, max_batch, cache_len, run_ctx,
                                         page_size=page, num_pages=n_pages)
        else:
            cache = dec.init_slot_cache(cfg, max_batch, cache_len, run_ctx)
        pool = paging.PagePool(n_pages)
        held = {}

        def admit(slot, plen):
            fresh = dec.init_cache(cfg, 1, cache_len, run_ctx)
            _, src = dec.prefill_cache(params, prompts[plen], fresh, cfg,
                                       run_ctx)
            held[slot] = pool.alloc(dec.pages_needed(
                cfg, cache_len, page, plen + steps))
            dec.slot_insert(cache, slot, src,
                            pages=held[slot] if paged else None)

        for slot, plen in enumerate((17, 64, 100, 128)):
            admit(slot, plen)
        tok = torch.zeros((max_batch, 1), dtype=torch.long, device=DEVICE)
        toks, logits_all, live = [], [], [[0, 1, 2, 3]]
        for i in range(steps):
            if forced is not None:
                tok = forced[i]
            toks.append(tok)
            logits, cache = dec.decode_step(params, cache, tok, cfg, run_ctx)
            logits_all.append(logits)
            tok = torch.argmax(logits, -1)[:, None]
            if i == 5:
                # slot 2 finishes; every other page is taken by requests
                # in flight, so the 33-token request in slot 4 gets the
                # pages slot 2 gave back
                others = pool.alloc(pool.available)
                dec.slot_evict(cache, 2)
                freed = held.pop(2)
                pool.free(freed)
                admit(4, 33)
                if not set(held[4]) <= set(freed):
                    fail(f"pages {held[4]} not recycled from {freed}")
                pool.free(others)
            live.append([0, 1, 3, 4] if i >= 5 else [0, 1, 2, 3])
        return toks, logits_all, live[:steps]

    reset(mods)
    toks, logits_p, live = run(ctx, paged=True)
    torch.cuda.synchronize()
    launched = counts(mods)
    want = expect(flash_attention=5 * cfg.num_layers,
                  flash_decode_paged=steps * cfg.num_layers)
    log(f"  launches on the paged path: {launched}")
    if launched != want:
        fail(f"paged path launched {launched}, expected {want}")
    _, logits_f, _ = run(ctx, paged=False, forced=toks)
    same = all(torch.equal(a[rows], b[rows])
               for a, b, rows in zip(logits_p, logits_f, live))
    _, logits_t, _ = run(tctx, paged=True, forced=toks)
    err = max(max_err(a, b) for a, b in zip(logits_p, logits_t))
    finite = all(bool(torch.isfinite(x).all()) for x in logits_p)
    log(f"  paged-path logits: bit-identical to the fixed-slot kernel path "
        f"{same}; vs the paged plain path max_abs_err={err:.3e} bound "
        f"{LOGIT_TOL:g}; finite {finite}")
    if not (same and finite and err <= LOGIT_TOL):
        fail("paged-path logits disagree with the fixed-slot or plain path")
    return launched


def serve_scheduled(torch, mods, serve, rt):
    """Phase 7c: paged serving behind the Scheduler at full width, with
    prefix sharing off and on, against a fixed-slot runner on the same
    trace and a fixed cost model (so the schedule is deterministic)."""
    log("# phase 7c: paged serving behind the Scheduler, qwen2-0.5b full "
        "width")
    args = serve.parse_args(SERVE_ARGV)
    cfg, ctx, params, _, _ = serve.setup(args)
    cost = rt.StepCostModel(**SCHED["cost"])
    reqs = rt.RequestStream(**SCHED["stream"]).generate(SCHED["horizon"])
    log(f"  {len(reqs)} requests, prompts "
        f"{sorted({r.prompt_len for r in reqs})}, templates "
        f"{sorted({r.template for r in reqs})}")
    runs, total = {}, {name: 0 for name in KERNEL_NAMES}
    for label, kw in (("paged, sharing off", SCHED["paged"]),
                      ("paged, sharing on",
                       dict(SCHED["paged"], prefix_sharing=True)),
                      ("fixed-slot", {})):
        runner = rt.SlotRunner(params, cfg, ctx, SCHED["max_batch"],
                               SCHED["cache_len"], **kw)
        sched = rt.Scheduler(SCHED["max_batch"], cost, runners=[runner],
                             chunk_tokens=SCHED["chunk"],
                             priority="decode_first")
        n = {"chunks": 0, "steps": 0}
        chunk, step = sched._prefill_chunk, runner.step

        def counted_chunk(lane, now, chunk=chunk):
            n["chunks"] += 1
            return chunk(lane, now)

        def counted_step(active, step=step):
            n["steps"] += 1
            return step(active)

        sched._prefill_chunk, runner.step = counted_chunk, counted_step
        reset(mods)
        t0 = time.perf_counter()
        recs, summary = sched.run(reqs, horizon_s=SCHED["horizon"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts(mods)
        for name in total:
            total[name] += launched[name]
        paged = "page_size" in kw
        decode = "flash_decode_paged" if paged else "flash_decode"
        want = expect(flash_attention=n["chunks"] * cfg.num_layers,
                      **{decode: n["steps"] * cfg.num_layers})
        done = [r for r in recs if r.completed]
        share = summary.get("prefix_sharing") or {}
        log(f"  {label}: {n['chunks']} prefill chunks, {n['steps']} decode "
            f"steps, {wall:.2f} s wall; conservation_ok "
            f"{summary['conservation_ok']}; completed {len(done)}/"
            f"{len(recs)}; launches {launched}"
            + (f"; prefix hits {share['hits']}/{share['lookups']}, prefill "
               f"tokens skipped {share['prefill_tokens_skipped']}, pages "
               f"saved {share['pages_saved']}/{share['pages_asked']}"
               if share else ""))
        if not summary["conservation_ok"]:
            fail(f"{label}: a request reached no single terminal state")
        if launched != want:
            fail(f"{label}: launched {launched}, expected {want}")
        if not done or any(len(runner.generated[r.rid]) != r.target_tokens
                           or not all(0 <= t < cfg.vocab_size for t in
                                      runner.generated[r.rid])
                           for r in done):
            fail(f"{label}: completed requests lack their tokens")
        if paged and not runner.pool.conserved():
            fail(f"{label}: page pool not conserved")
        runs[label] = (runner.generated, share)
    off, on, fixed = (runs[k][0] for k in runs)
    if off != fixed:
        fail("paged tokens differ from fixed-slot tokens on one schedule")
    share = runs["paged, sharing on"][1]
    if not (share.get("prefill_tokens_skipped", 0) > 0
            and share.get("pages_saved", 0) > 0):
        fail("prefix sharing found no hit")
    agree = sum(a == b for rid in on for a, b in zip(on[rid], off[rid]))
    log(f"  paged tokens identical to fixed-slot tokens: True; sharing-on "
        f"tokens equal to sharing-off: {agree}/"
        f"{sum(len(v) for v in off.values())} (chunk products of other "
        f"M may round differently; reported, not required)")
    return total


def serve_streaming(torch, mods, serve, rt):
    """Phase 7d: the streaming launcher at full width, as a user runs it:
    ``measured_cost_model``, then ``ContinuousBatchingServer`` over a
    fixed-slot ``SlotRunner`` on a Table I trace.  Every fused prefill and
    decode step of the run (the cost model's timed calls and the server's)
    is counted where the engine makes it, so the launch counts are held to
    prefills x 24 and decode steps x 24."""
    log("# phase 7d: streaming launcher, qwen2-0.5b full width")
    args = serve.parse_args(SERVE_ARGV + STREAM_ARGV)
    eng = rt.engine
    n = {"prefill": 0, "decode": 0}
    orig = {"prefill_cache": eng.prefill_cache,
            "decode_step": eng.decode_step,
            "measured_cost_model": rt.measured_cost_model}

    def counting(key, fn):
        def call(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        return call

    def cost_model(*a, **kw):
        cost = orig["measured_cost_model"](*a, **kw)
        n["cost_model"] = dict(n)
        return cost

    eng.prefill_cache = counting("prefill", orig["prefill_cache"])
    eng.decode_step = counting("decode", orig["decode_step"])
    rt.measured_cost_model = cost_model
    try:
        reset(mods)
        t0 = time.perf_counter()
        res = serve.run_streaming(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts(mods)
    finally:
        eng.prefill_cache = orig["prefill_cache"]
        eng.decode_step = orig["decode_step"]
        rt.measured_cost_model = orig["measured_cost_model"]
    cfg, recs, summary = res["cfg"], res["records"], res["summary"]
    runner = res["runner"]
    by_cost = n.pop("cost_model")
    log(f"  {summary['n_requests']} requests, {wall:.2f} s wall; "
        f"measured_cost_model made {by_cost['prefill']} prefills and "
        f"{by_cost['decode']} decode steps, the server "
        f"{n['prefill'] - by_cost['prefill']} and "
        f"{n['decode'] - by_cost['decode']}; launches {launched}")
    want = expect(flash_attention=n["prefill"] * cfg.num_layers,
                  flash_decode=n["decode"] * cfg.num_layers)
    if launched != want:
        fail(f"streaming launcher launched {launched}, expected {want}")
    if runner.page_size is not None:
        fail("the streaming launcher's runner is not fixed-slot")
    done = [r for r in recs if r.completed]
    if (len(recs) != summary["n_requests"]
            or len({r.rid for r in recs}) != len(recs)
            or any((r.finish_s is not None) == (r.dropped is not None)
                   for r in recs)):
        fail("streaming: a request reached no single terminal state")
    if not done or any(len(runner.generated[r.rid]) != r.target_tokens
                       or not all(0 <= t < cfg.vocab_size
                                  for t in runner.generated[r.rid])
                       for r in done):
        fail("streaming: completed requests lack their tokens")
    log(f"  conservation: {len(done)} completed + "
        f"{summary['dropped']} dropped = {len(recs)} requests; "
        f"slo_attainment {summary['slo_attainment']:.4f}, ttft_p50 "
        f"{summary['ttft_p50_s']:.4f} s (sim clock)")
    return launched


# ---------------------------------------------------------------------------
# phase 8: the training path


def train_setup(torch):
    """qwen2-0.5b at full width and depth, f32 params from the seed, one
    batch from TokenData, and the port's training modules."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenData
    from repro_torch.models.transformer import RunCtx, init_params
    cfg = get_config(TRAIN["arch"])
    ctx = RunCtx(device=DEVICE, remat=True, loss_chunk=TRAIN["loss_chunk"])
    gen = torch.Generator(device=DEVICE).manual_seed(TRAIN["seed"])
    params = init_params(gen, cfg, device=DEVICE)
    data = TokenData(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                     seed=TRAIN["seed"])
    x, y = data.sample(np.random.default_rng(TRAIN["seed"]), TRAIN["batch"])
    batch = {"tokens": torch.from_numpy(x).to(DEVICE),
             "labels": torch.from_numpy(y).to(DEVICE)}
    return cfg, ctx, params, batch


def train_steps(torch, cfg, ctx, params, backend, on_phase=None):
    """(dense_step, compressed_step, k, n): the kernel path (``fused_sgdm``
    and ``scatter_aggregate``) or the plain one."""
    from repro_torch.optim.optimizers import sgdm_update
    from repro_torch.train.ddp import make_ddp_steps

    def opt_update(g, s, p, lr):
        return sgdm_update(g, s, p, lr=lr, momentum=TRAIN["momentum"],
                           backend=backend)

    return make_ddp_steps(cfg, ctx, opt_update, lambda step: TRAIN["lr"],
                          TRAIN["cr"], params,
                          use_scatter_agg=backend == "kernel",
                          on_phase=on_phase)


def flat_grad(torch, cfg, ctx, params, batch):
    """The flat f32 gradient of the training loss at ``params``."""
    from repro_torch.core.compression import flatten_grads
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import leaves, unflatten
    live = [p.detach().requires_grad_() for p in leaves(params)]
    total, _ = make_loss_fn(cfg, ctx)(unflatten(params, live), batch)
    grads = torch.autograd.grad(total, live)
    return flatten_grads(unflatten(params, list(grads)))[0]


def train_path(torch, mods):
    """Dense step, two compressed steps and the adaptive rule on the kernel
    path, counted; the same steps on the plain path; the two compared."""
    from repro_torch.core.compression import AdaptiveCompressor
    from repro_torch.kernels import ops
    from repro_torch.optim.optimizers import sgdm_init
    from repro_torch.tree import leaves
    log("# phase 8: training, qwen2-0.5b full width and depth, "
        f"batch {TRAIN['batch']} x {TRAIN['seq']}")
    cfg, ctx, params, batch = train_setup(torch)
    rates = torch.ones(1, device=DEVICE)
    n_leaves = len(leaves(params))

    def run(backend):
        dense, comp, k, n = train_steps(torch, cfg, ctx, params, backend)
        p, s, ms = params, sgdm_init(params), []
        for step, fn in enumerate((dense, comp, comp)):
            p, s, m = fn(p, s, batch, rates, step)
            ms.append({key: float(v) for key, v in m.items()})
        return p, s, ms, k, n

    reset(mods)
    pk, sk, mk, k, n = run("kernel")
    flat = flat_grad(torch, cfg, ctx, pk, batch)
    ac = AdaptiveCompressor(cr=TRAIN["cr"], delta=0.3, use_block_topk=True)
    sent, use = ac.step(flat)
    torch.cuda.synchronize()
    launched = counts(mods)
    want = expect(fused_sgdm=3 * n_leaves, scatter_aggregate=2, block_topk=1)
    log(f"  n = {n} floats in {n_leaves} leaves, k = {k} per compressed "
        f"step; launches on the training path: {launched}")
    if launched != want:
        fail(f"training path launched {launched}, expected {want}")
    log(f"  adaptive rule (block top-k, cr {TRAIN['cr']}, delta 0.3): gap "
        f"{ac.ewma.value:.6f} (a first EWMA update takes the gap as it "
        f"is: ewma {ac.ewma.value:.6f}), decision "
        f"{'compressed' if use else 'dense'}")
    g2d, _ = ops._to_blocks(flat, 1024)
    plain = mods.bt.block_topk_ref(g2d, ops._k_for(TRAIN["cr"], 1024))[0]
    comp = plain.reshape(-1)[:n] if use else flat
    if not same_bits(torch, sent, comp):
        fail("block_topk on the training gradient differs from its plain "
             "version")
    log("  block_topk on the training gradient: bit-exact with its plain "
        "version")
    del g2d, plain, comp, sent, flat

    pt, st, mt, _, _ = run("torch")
    torch.cuda.synchronize()
    if counts(mods) != launched:
        fail(f"the plain path launched kernels: {counts(mods)}")
    loss0 = mk[0]["loss"]
    for i, (a, b) in enumerate(zip(mk, mt)):
        d_loss, d_gap = abs(a["loss"] - b["loss"]), abs(a["gap"] - b["gap"])
        log(f"  step {i} ({'dense' if i == 0 else 'compressed'}): loss "
            f"{a['loss']:.6f} (plain {b['loss']:.6f}, diff {d_loss:.3e}), "
            f"gap {a['gap']:.6f} (plain {b['gap']:.6f}, diff {d_gap:.3e})")
        if not (math.isfinite(a["loss"]) and 0.0 <= a["gap"] <= 1.0):
            fail(f"step {i}: loss {a['loss']} or gap {a['gap']} out of range")
        if (d_loss > TRAIN_TOL["loss_rel"] * abs(b["loss"])
                or d_gap > TRAIN_TOL["gap_abs"]):
            fail(f"step {i}: kernel path disagrees with the plain path")
    if not abs(loss0 - math.log(cfg.vocab_size)) < 1.0:
        fail(f"first loss {loss0} is not near ln(vocab) for random weights")
    d_param = max(max_err(a, b) for a, b in zip(leaves(pk), leaves(pt)))
    d_mom = max(max_err(a, b) for a, b in
                zip(leaves(sk["mom"]), leaves(st["mom"])))
    moved = max(max_err(a, b) for a, b in zip(leaves(pk), leaves(params)))
    log(f"  after 3 steps: params max_abs_err {d_param:.3e}, momentum "
        f"{d_mom:.3e} vs the plain path (bound {TRAIN_TOL['param_abs']:g}); "
        f"params moved up to {moved:.3e} from the start")
    if not (d_param <= TRAIN_TOL["param_abs"] and moved > 0):
        fail("training params disagree with the plain path")
    return launched, {"cfg": cfg, "ctx": ctx, "params": pk, "state": sk,
                      "batch": batch, "n": n, "k": k}


# ---------------------------------------------------------------------------
# phase 9: timing


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

    # paged, at phase 4's serving shape: pages of 16, 12 columns, 80 rows
    pg, ncols, rows = 16, 12, 80
    kp = torch.randn((rows, pg, kv, hd), generator=gen, device=DEVICE)
    vp = torch.randn((rows, pg, kv, hd), generator=gen, device=DEVICE)
    bt = block_table(torch, "scrambled", b, ncols, rows, gen)

    def gather_sdpa():                 # two calls: pool[bt] gather + SDPA
        view = [pool[bt.long()].reshape(b, ncols * pg, kv, hd)[:, :kv_len]
                .transpose(1, 2) for pool in (kp, vp)]
        return F.scaled_dot_product_attention(qdt, *view, enable_gqa=True)

    paged = time_fns(
        torch, lambda: fd.flash_decode_paged(qd, kp, vp, bt, kvl),
        lambda: fd.flash_decode_paged_ref(qd, kp, vp, bt, kvl), gather_sdpa)
    paged["bound_ms"], paged["bound_by"] = bound(
        4 * (2 * qd.numel() + 2 * b * kv_len * kv * hd) + 4 * b
        + 4 * bt.numel(), 4 * hd * b * h * kv_len, "float32")
    return {"flash_attention": attn, "flash_decode": dec,
            "flash_decode_paged": paged}


def time_paged_steps(torch, serve, dec, rt, card, steps=8):
    """A decode step of a fixed-slot and of a paged cache at one occupancy
    (8 slots, prompt 128, cache 160, pages of 16), host clock around
    ``steps`` synchronised steps from the same start, in turns (fixed,
    paged, paged, fixed) within this call; then ``measured_cost_model``."""
    log(f"# phase 9: paged vs fixed decode step on {card}")
    args = serve.parse_args(SERVE_ARGV)
    cfg, ctx, params, prompts, _ = serve.setup(args)
    cache_len = args.prompt_len + args.gen
    src = dec.init_slot_cache(cfg, args.batch, cache_len, ctx)
    _, src = dec.prefill_cache(params, prompts, src, cfg, ctx)
    caches = {"fixed": dec.init_slot_cache(cfg, args.batch, cache_len, ctx),
              "paged": dec.init_paged_cache(
                  cfg, args.batch, cache_len, ctx, page_size=16,
                  num_pages=args.batch * cache_len // 16)}
    per_slot = cache_len // 16
    for slot in range(args.batch):
        dec.slot_insert(caches["fixed"], slot, src, src_slot=slot)
        dec.slot_insert(caches["paged"], slot, src, src_slot=slot,
                        pages=range(slot * per_slot, (slot + 1) * per_slot))
    tok = torch.zeros((args.batch, 1), dtype=torch.long, device=DEVICE)
    pos0 = {k: c["pos"] for k, c in caches.items()}

    def run(kind):
        cache = caches[kind]
        cache["pos"] = pos0[kind]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            dec.decode_step(params, cache, tok, cfg, ctx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    run("fixed"), run("paged")                     # warm-up
    order = ("fixed", "paged", "paged", "fixed")
    ms = [(kind, run(kind)) for kind in order]
    log("  decode ms/step, in turns: " + ", ".join(
        f"{kind} {t:.3f}" for kind, t in ms) + f"  [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cost = rt.measured_cost_model(params, cfg, ctx, args.batch, cache_len,
                                  args.prompt_len)
    wall = time.perf_counter() - t0
    log(f"  measured_cost_model (b {args.batch}, cache {cache_len}, prompt "
        f"{args.prompt_len}): decode_step_s {cost.decode_step_s:.6f}, "
        f"prefill_token_s {cost.prefill_token_s:.3e}, prefill_base_s "
        f"{cost.prefill_base_s:.6f}; the call took {wall:.3f} s  [{card}]")


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
    report_profile(profiled(torch, step, steps), "decode step", steps,
                   step_ms, card, top)


def report_profile(events, label, steps, step_ms, card, top=8):
    """Device time by kernel and host time by op from torch.profiler's
    ``events`` over ``steps`` steps, and the device's idle share of
    ``step_ms``; "not measured" where the profiler saw no device time."""
    dev = [e for e in events if _on_device(e)]
    kernel_ms = sum(_device_us(e) for e in dev) / steps / 1e3
    if kernel_ms <= 0:
        log("  torch.profiler recorded no device time: device time by "
            "kernel not measured")
    else:
        log(f"  {label}: kernels {kernel_ms:.3f} ms (torch.profiler, "
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
    log(f"# phase 9: serving times on {card}")
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


def time_train_kernels(torch, mods, train):
    """Kernel, plain and library times of the training kernels at the
    training path's shapes, each beside its bound."""
    from repro_torch.core.compression import global_topk
    from repro_torch.kernels import ops
    from repro_torch.tree import leaves
    bt, sa = mods.bt, mods.sa
    flat = flat_grad(torch, train["cfg"], train["ctx"], train["params"],
                     train["batch"])
    n, k = train["n"], train["k"]
    times = {}

    g2d, _ = ops._to_blocks(flat, 1024)
    kb = ops._k_for(TRAIN["cr"], 1024)
    rows = g2d.shape[0]
    t = {"ms": device_ms(torch, lambda: bt.block_topk(g2d, kb))}
    t["plain_ms"] = device_ms(torch, lambda: bt.block_topk_ref(g2d, kb),
                              iters=5)
    t["library_ms"] = device_ms(
        torch, lambda: torch.topk(torch.abs(g2d), kb, dim=-1))
    t["bound_ms"], t["bound_by"] = bound(
        8 * g2d.numel() + 4 * rows, (2 + 2 * bt.N_BISECT) * g2d.numel(),
        "float32")
    t["shape"] = f"g2d ({rows}, 1024) f32, k {kb} per row"
    times["block_topk"] = t

    params = leaves(train["params"])
    moms = leaves(train["state"]["mom"])
    grads = list(torch.split(flat, [p.numel() for p in params]))
    grads = [g.reshape(p.shape) for g, p in zip(grads, params)]
    lr = torch.tensor(TRAIN["lr"], device=DEVICE)
    mu = TRAIN["momentum"]
    t = {"ms": device_ms(torch, lambda: [
        bt.fused_sgdm(p, m, g, lr, mu) for p, m, g in
        zip(params, moms, grads)])}
    t["plain_ms"] = device_ms(torch, lambda: [
        bt.fused_sgdm_ref(p, m, g, lr, mu) for p, m, g in
        zip(params, moms, grads)], iters=5)
    fused_sgd = getattr(torch, "_fused_sgd_", None)
    t["library_ms"] = None                  # a torch without it: no yardstick
    if fused_sgd is not None:
        p_copy = [p.clone() for p in params]
        m_copy = [m.clone() for m in moms]
        t["library_ms"] = device_ms(torch, lambda: fused_sgd(
            p_copy, grads, m_copy, weight_decay=0.0, momentum=mu, lr=lr,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False))
        del p_copy, m_copy
    t["bound_ms"], t["bound_by"] = bound(20 * n, 5 * n, "float32")
    t["shape"] = f"{len(params)} leaves, {n} f32 params (one step's update)"
    times["fused_sgdm"] = t

    vals, idx = global_topk(flat, k)
    vals, idx = vals[None].contiguous(), idx[None].contiguous()
    idx64 = idx[0].long()
    t = {"ms": device_ms(torch, lambda: sa.scatter_aggregate(vals, idx, n))}
    t["plain_ms"] = device_ms(
        torch, lambda: sa.scatter_aggregate_ref(vals, idx, n), iters=5)
    t["library_ms"] = device_ms(
        torch, lambda: torch.zeros(n, device=DEVICE).index_put_(
            (idx64,), vals[0], accumulate=True), iters=5)
    t["bound_ms"], t["bound_by"] = bound(8 * k + 4 * n, k, "float32")
    t["shape"] = f"D 1, k {k}, n {n} (the compressed step's aggregate)"
    times["scatter_aggregate"] = t
    return times


def time_training(torch, train, card, reps=3):
    """Wall time of the dense and the compressed step (host clock around
    synchronised steps) and each step's phases (CUDA events recorded as
    each phase ends)."""
    from repro_torch.optim.optimizers import sgdm_init
    log(f"# phase 9: training step times on {card}")
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    dense, comp, _, _ = train_steps(torch, train["cfg"], train["ctx"],
                                    train["params"], "kernel", on_phase=mark)
    rates = torch.ones(1, device=DEVICE)
    p, s = train["params"], sgdm_init(train["params"])
    for label, fn in (("dense", dense), ("compressed", comp)):
        walls, splits = [], []
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.reset_peak_memory_stats()
        for i in range(reps + 1):
            torch.cuda.synchronize()
            marks.clear()
            mark("start")
            t0 = time.perf_counter()
            p, s, _ = fn(p, s, train["batch"], rates, i)
            torch.cuda.synchronize()
            if i == 0:
                continue                      # warm-up
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append({name: marks[j - 1][1].elapsed_time(ev)
                           for j, (name, ev) in enumerate(marks) if j})
        wall = sorted(walls)[len(walls) // 2]
        split = {name: sorted(sp[name] for sp in splits)[len(splits) // 2]
                 for name in splits[0]}
        retries = (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                   - retries)
        log(f"  {label} step: {wall:.3f} ms wall (median of {reps}; all "
            f"{', '.join(f'{w:.3f}' for w in walls)}); phases by CUDA "
            "events: " + ", ".join(f"{name} {ms:.3f} ms"
                                   for name, ms in split.items())
            + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"allocated, {retries} allocator retries  [{card}]")
        state = {"p": p, "s": s}

        def step():
            state["p"], state["s"], _ = fn(state["p"], state["s"],
                                           train["batch"], rates, 0)

        report_profile(profiled(torch, step, 1), f"{label} step", 1, wall,
                       card)
        p, s = state["p"], state["s"]


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

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import scatter_agg as sa
    from repro_torch.launch import serve
    from repro_torch import serve as rt
    from repro_torch.models import decode as dec
    from repro_torch.models import paging
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import leaves
    mods = types.SimpleNamespace(fa=fa, fd=fd, bt=bt, sa=sa)

    build(_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n_train = sum(p.numel() for p in leaves(init_params(
        None, get_config(TRAIN["arch"]), device="meta")))
    errs = check_kernels(torch, fa, fd)
    errs.update(check_train_kernels(torch, bt, sa, n_train))
    launched, _ = serve_offline(torch, mods, serve, dec)
    serve_slots(torch, mods, serve, dec)
    serve_paged(torch, mods, serve, dec, paging)
    sched_launched = serve_scheduled(torch, mods, serve, rt)
    serve_streaming(torch, mods, serve, rt)
    launched["flash_decode_paged"] = sched_launched["flash_decode_paged"]
    train_launched, train = train_path(torch, mods)
    launched.update({name: train_launched[name] for name in
                     ("block_topk", "fused_sgdm", "scatter_aggregate")})
    times = time_train_kernels(torch, mods, train)
    time_training(torch, train, card)
    del train
    torch.cuda.empty_cache()
    times.update(time_kernels(torch, fa, fd))
    time_serving(torch, serve, dec, card)
    time_paged_steps(torch, serve, dec, rt, card)

    sources = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:86"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:148"),
        "flash_decode_paged": ("src/repro_torch/csrc/flash_decode.cu",
                               "src/repro/kernels/flash_decode.py:181"),
        "block_topk": ("src/repro_torch/csrc/block_topk.cu",
                       "src/repro/kernels/block_topk.py:59"),
        "fused_sgdm": ("src/repro_torch/csrc/fused_sgdm.cu",
                       "src/repro/kernels/block_topk.py:128"),
        "scatter_aggregate": ("src/repro_torch/csrc/scatter_agg.cu",
                              "src/repro/kernels/scatter_agg.py:61")}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = times[name]
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        extra = (f"{t.pop('call_ms'):.4f} ms per call issued back to back"
                 if "call_ms" in t else f"at {t.pop('shape')}")
        log(f"  {name}: device {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, library {lib}, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}); {extra}  [{card}]")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launched[name],
                        "max_abs_err": errs[name], **t})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

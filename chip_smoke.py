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
   6b. serve recurrentgemma-2b at full width and depth (26 layers, 8 of
   them local attention at hd 256, g 10) and mixtral-8x22b at full width
   and 2 of its 56 layers (SWA at hd 128, g 6; 8 experts top-2 at C 320)
   offline through ``run_offline`` (random f32 weights from seed 0, batch
   8, prompt 128, 16 greedy tokens), counted: one ``flash_attention`` per
   attention layer and one ``flash_decode`` per attention layer a step;
   the same prompts greedily on the plain path give the same tokens, and
   logits after prefill and after the last step within LOGIT_TOL;
   6c. recurrentgemma-2b at batch 1 with a 2 112-token prompt, past its
   2 048-token window, so the ring wraps at prefill and through 16 steps,
   held the same way;
   6d. xlstm-125m at full width and depth (12 layers, mLSTM and sLSTM
   alternating, 4 heads of 192; 77 627 184 f32 params from seed 0) offline
   through ``run_offline`` at batch 8, prompt 128, 16 greedy tokens: no
   kernel launched (its blocks are plain PyTorch, as the reference's are
   plain jnp), and the same params and prompts on the CPU give the same
   greedy tokens, logits after prefill and after the last step within
   LOGIT_TOL;
   6e. whisper-base at full width and depth (6 encoder and 6 decoder
   layers, 83 263 488 params; 1 536 encoder frames from the launcher's
   audio stream through ``prefill_cross_kv``) the same way as 6b, counted:
   6 encoder + 6 self + 6 cross ``flash_attention`` at prefill and 12
   ``flash_decode`` a step (self + cross); the plain path on the same
   frames gives the same tokens, logits within LOGIT_TOL;
   6f. qwen2-vl-2b's text path at full width and depth (28 layers, 12 q /
   2 kv heads of 128, tied 151 936-token vocab, 1 543 714 304 params; 1-D
   RoPE, as the reference serves it) the same way: 28 ``flash_attention``
   at prefill and 28 ``flash_decode`` a step;
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
   fixed-slot tokens, prefix hits with sharing on; then the paged run
   (sharing off) under a ``ServeController`` ticking every 0.25 s of a
   0.25 s window: conservation, launches as predicted, at least one
   action, every value on its axis, and the same actions, chunks, steps
   and summary as the same controlled schedule on the CPU at reduced
   depth (a fixed cost model makes the schedule independent of tokens);
   7d. the streaming launcher (``run_streaming``: ``measured_cost_model``,
   then ``ContinuousBatchingServer`` over a fixed-slot ``SlotRunner``) on a
   short Table I trace, counted the same way: launches equal to fused
   prefills x 24 and decode steps x 24, every request in one terminal
   state, completed requests with all their tokens;
   7e. recurrentgemma-2b at full width on a paged cache (pages of 16)
   through ``SlotRunner`` with ``ChunkedPrefill`` (chunk 64) behind the
   Scheduler, phase 7c's trace over 4 slots (slots released and taken
   again): only ``flash_decode_paged`` at decode, launches equal to
   chunks x 8 and steps x 8, tokens identical to a fixed-slot runner on the
   same schedule; RG-LRU state through ``slot_insert``/``slot_evict`` of a
   paged cache bit for bit;
   7f. xlstm-125m the same way (no kernel launched at all), with the
   mLSTM and sLSTM states through ``slot_insert``/``slot_evict`` of a
   fixed-slot cache and ``paged_insert``/``paged_evict`` of a paged one
   bit for bit;
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
8b. run the paper's own iteration, ``repro_torch.core.ScaDLESTrainer``,
   on the edge MLP at full width (d_in 3 072, hidden 64, 10 classes;
   197 322 f32 params from seed 0), 16 devices, Table I S1, the example's
   data (``examples/scadles_streaming.py``): the ScaDLES arm (rate-weighted
   batches, truncation, adaptive top-k 0.1/0.3, b_max 128) and the DDL arm
   (fixed batch 64, persistence), then ``jetson-mixed`` fleets under async
   and semi-sync (k 4), 30 rounds each, on the card and on the CPU from the
   same params and seeds: every host field of every round identical, loss
   and final params within SCADLES_TOL, no kernel launched; print the
   sim-time speedup, accuracies and summaries; then time rounds at the
   config's defaults (b_max 1024, S2) and async rounds on the carry path:
   wall ms, host time in buffers and the draw, CUDA-event splits (upload,
   gradients, compression, aggregation, update), torch.profiler's device
   busy share, peak memory, and MFU against the K80 peak in sim time and
   against the card's f32 peak in wall time;
8c. run the non-IID data plane (``repro_torch.streamdata``) through the
   trainer, the edge MLP at full width, 16 devices, the non-IID sweep's
   data (``ClassClusterData(10, 192 a class, test 32 a class, noise 0.8,
   seed 0)``), each data source built anew from seed 0 for each device:
   (a) the example's two arms under ``--skew dirichlet`` (alpha 0.1, S1,
   b_max 128, 30 rounds; skew-corrected weights in the ScaDLES arm); (b)
   the non-IID sweep's regime on a churning ``jetson-mixed`` fleet (alpha
   0.05, lr 0.15, skew weights and non-IID damping) under semi-sync k 8
   and async, held at 5 and 64 rounds (f32 noise grows past the param
   limit by round 7 and past the loss limit by round 114; see
   STREAMDATA), with the held-out global test loss
   of ``benchmarks/common.py::global_eval_fn``; (c) the sharded loader
   (contiguous placement, drop-oldest buffers of 96 that evict, short
   batches) and a rotating-drift stream, each with a diurnal rate curve,
   S2, 30 rounds.  Card against CPU at phase 8b's limits, the eval loss
   within the loss limit, the loader's conservation on the card, no
   kernel launched; prints the realised divergence, the time to an eval
   loss of 0.1 and the accuracy; then times lockstep rounds at b_max 1024,
   S2 through a Dirichlet(0.1) stream and through the sharded loader,
   split as phase 8b's;
8d. hold the paper CNN (``models/cnn.py``, paper-cnn: 4 stages, base 64,
   d_ff 256; params from ``init_cnn`` on the CPU) on a 128 x 32 x 32 x 3
   batch from seed 0 against the CPU with cuDNN's TF32 allowed for the
   phase: logits within 1e-4 of their max, the loss within 1e-5, every
   gradient leaf within 1e-4 of its max; no kernel launched; then time
   forward + backward with CUDA events beside the counted flops;
8e. (after phase 9's training step times, once phase 8's state is freed)
   the training launcher: (a) ``train.make_train_step`` on qwen2-0.5b at
   full width and depth (phase 8's 8 x 256 batch, uniform sample weights,
   momentum SGD 0.9, lr 1e-3): two steps with the counters set to 0 just
   before and read just after, one ``fused_sgdm`` per leaf per step and
   nothing else, held against the same two steps on the plain optimizer
   (no launch) at TRAIN_TOL; then one step at ``n_micro`` 2 against 1 at
   MICRO_TOL, and ``n_micro`` 2 with ``grad_wire_bf16`` finite and apart
   from the f32 wire; (b) ``repro_torch.launch.train`` at LAUNCH_ARGV
   (Adam, 20 steps of 16 x 128 with ScaDLES weights, ``--ckpt`` to a
   temporary directory) on the card: no kernel launched (Adam and the
   training attention are plain), every loss finite, the first within 1.0
   of ln V and the last below it; logs the printed s/it, the median
   synchronised step time of steps 5-19 and the peak memory; (c) the same
   argv at LAUNCH_CPU on the card and with ``--device cpu`` from the same
   params: losses and lr at LAUNCH_TOL, params within 2 * sum(lr_t) and
   under a LAUNCH_TOL share of elements apart; (d) the checkpoint of (b)
   restored by ``restore_pytree`` on the card and on the CPU, bit for bit,
   one ``.paths.json`` key per leaf, with the file's size and the save and
   restore times;
8f. (after 8e) the training attention, ``chunked_attention(backend=
   "torch")`` (the chunked flash with its own backward): forward and
   ``torch.autograd.grad`` of ``sum(sin(o))`` on the card against the CPU
   at qwen2-0.5b's head layout (h 14, kv 2, hd 64, f32), 2 x 512 causal
   and swa 256, chunks 128, at FLASH_TRAIN's bars, none of the six
   kernels launched; then one causal forward + backward at 2 x 4 096 in
   turns with the full path (``flash_attention_ref`` under autograd),
   held against it, with the peak memory above the inputs, the wall ms
   and the launches (torch.profiler) of each; the chunked flash's peak
   must be below the full path's;
8g. the training launcher at full width and depth on a long sequence
   (LONG_ARGV: 3 Adam steps of 2 x 4 096, chunks of 128): every loss
   finite, lr the schedule's, no kernel launched; logs the printed s/it,
   each synchronised step and the peak memory;
8h. ``launch/mesh.py::make_test_mesh((1, 1))`` on a one-rank NCCL group
   (a ``HashStore``, destroyed afterwards): ``context_parallel_attention``
   over it equals ``chunked_attention(static_offset=False)`` bit for bit,
   output and gradients, causal and swa; ``psum_weighted`` returns the
   gradient and the rate;
8j. (after 8h) the sharded training step: on a one-rank NCCL group's
   (1, 1) ("data", "model") mesh, ``make_plan`` -> ``make_run_ctx`` ->
   ``distribute`` of phase 8's qwen2-0.5b params (full width and depth,
   f32) and 8 x 256 batch with uniform sample weights ->
   ``make_train_step(..., grad_shardings=named(...))`` with momentum SGD
   on ``fused_sgdm``, two steps at ``n_micro`` 1 and 2 with the counters
   set to 0 just before and read just after (one ``fused_sgdm`` per leaf
   a step, on its local shard, nothing else), every output leaf a DTensor
   with its spec's placements, params, momentum, loss and grad norm held
   against the same steps without a mesh at TRAIN_TOL; then one step of
   each in turns (unsharded, sharded, sharded, unsharded) with its peak
   memory, and the launches a step under torch.profiler;
8k. (after 8j) the counting layer: (a) ``dist/hlo_cost.py`` and
   ``obs/mfu.py::lowered_flops`` count phase 8e's ``make_train_step``
   (momentum SGD) from the card's params and batch: the card's allocated
   bytes equal before and after, params and batch bitwise unchanged, no
   launch counter moved, and the count equal to the one taken from CPU
   copies; (b) that step on the card (one untimed step, then the warm
   median of COUNT's steps, counted: one ``fused_sgdm`` per leaf a step)
   against its counted flops (the f32 67 TFLOP/s peak: TF32 is off) and
   bytes (3.35 TB/s), naming the bound; (c) ``dist/calibrate.py`` at the
   reference's two points, equal to REF_CALIBRATION exactly; (d)
   ``python -m repro_torch.launch.dryrun`` for qwen2-0.5b at COUNT's
   shapes on a 256-rank fake group, each artifact complete, its flops
   above 0 and the train one with all-gathers and reduce-scatters.  (c)
   and (d) run in their own processes while (a) and (b) run;
8l. (after 8k) sharded serving: (a) qwen2-0.5b at full width and depth
   (phase 6's params, prompts and argv; f32) with params and cache placed
   by ``dist/sharding.py`` on a one-rank NCCL group's (1, 1) mesh:
   ``prefill_cache`` (``flash_attention`` on local shards) and 32 greedy
   ``decode_step``s (``flash_decode`` with ``return_lse`` on local shards,
   merged by the log-sum-exp combine), counters set to 0 just before and
   read just after, against the same run without a mesh: tokens equal to
   it and to phase 6's, logits bit-identical at every step (on one rank
   every collective is the identity and the combine exact); then both
   runs in turns (unsharded, sharded, sharded, unsharded) with their
   prefill ms and decode ms a step; (b) ``flash_decode(return_lse=True)``
   against ``flash_decode_ref(return_lse=True)`` at LSE_CASES (qwen2-0.5b's
   decode shape, recurrentgemma-2b's hd 256 g 10 at b 1 and b 8; f32 and
   bf16): the lse within TOL, o bit-identical with and without the flag;
   (c) ``python -m repro_torch.launch.dryrun`` for one combination of each
   class DTensor once refused (DRYRUN_CLASSES) on a 256-rank fake group,
   in their own processes started after (b) and collected after 8i, each
   artifact complete with no unknown op;
8i. the five ``examples/*_torch.py``, each in a fresh interpreter with
   ``PYTHONPATH=src`` in a temporary working directory: quickstart (the
   loss falls), train_e2e at its default and ``--full --steps 5``
   (xlstm-125m at full width and depth; s/it printed, checkpoint
   written), serve_batched (run as ``__main__`` by ``runpy`` so its
   ``flash_attention`` and ``flash_decode`` launches are counted, both
   above 0 and nothing else; requests conserved), scadles_streaming (iid
   and ``--skew dirichlet``) and fleet_churn, whose lines must equal the
   same scripts' ``--device cpu`` runs (made at the same time), losses
   and accuracies within one unit of their printed digit; wall times
   logged;
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
   and ``measured_cost_model``; the attention kernels at
   recurrentgemma-2b's shapes (prefill at b 8 x 128 and b 1 x 2 112, swa
   window 2 048; decode over a full 2 048-token ring at b 8 and b 1), and
   a prefill and decode steps of each phase-6b model, with one MoE FFN at
   the decode shape; the attention kernels at whisper-base's shapes (the
   encoder's bidir 8 x 1 536 x 1 536, a prompt's cross-attention over the
   1 536 frames, decode over them at b 8 and b 1) and a prefill and
   decode steps of each phase 6d-6f model, with whisper's
   ``prefill_cross_kv`` on its own and the kernel launches a step;
10. print one JSON line of kernels (each with its launches by path), then
   the result line.

Phase 2 also fails if any instance of the decode kernel
(``flash_decode_kernel``) or of the prefill kernel (``flash_fwd_wgmma``)
spills registers, and logs the registers and shared memory of the f32
hd-256 instance, whose head dim is split over a cluster of two blocks.
Phase 4 also checks the split-K decode: kv_len at every split edge of a
16 384-token context (f32, bf16; contiguous, pages of 16 and of 5); an S
the split does not divide; g 16 at hd 64 and 256; and the prefill kernel
at an 8 192-token causal prompt (f32 and bf16), a 64-query chunk at its
end (q_offset 8 128, f32), hd 128 with g 6 at a ragged 200 (f32 and
bf16), and f32 hd 256 at recurrentgemma's shapes, a ragged bidir 130, a
causal q_offset on a key-tile edge and a 64-query chunk past the window
(q_offset 4 032 over 4 096 keys), and at whisper-base's (bidir 1 536 x
1 536, 128 and a ragged 77 queries over 1 536 keys; decode over 1 536
keys at b 8 and b 1, and through pages of 16) and qwen2-vl-2b's shapes;
every attention call repeated bit for bit.  Phase 9 times both decode entries at the serving shape and at S
= kv_len = 16 384, and ``flash_attention`` at the serving shape and at an
8 192-token prompt, f32 and bf16, its f32 bound at the 3xTF32 rate
(``time_attention``), and at recurrentgemma-2b's prefill shapes
(``time_zoo_kernels``); both take the kernel module as an argument, so a
parent tree's kernel can be timed by the same code.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": 1}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

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
# phase 6d: xlstm-125m on the card against the CPU.  Its mLSTM divides by
# max(|q.n|, exp(-m)), and with random weights that normaliser sits near
# cancellation for some (token, head), so the model amplifies f32 rounding
# about 3 000-fold: two correct f32 implementations on one CPU, the
# reference and the port, give prefill logits 6.8e-4 apart and 8.7e-4
# after 16 greedy steps (tests/test_torch_xlstm.py::
# test_full_size_f32_spread_against_the_reference), and the card's
# cuBLAS/cumsum orders give 1.8e-3.  LOGIT_TOL (1e-3) sits below that
# spread, so this phase holds the logits at XLSTM_TOL (1e-2, ten times the
# spread of the two CPU implementations), the CPU teacher-forced on the
# card's tokens; a card token must be the CPU's argmax wherever the CPU's
# top-2 gap exceeds twice XLSTM_TOL (a closer pair is a tie at this
# precision: counted and printed)
XLSTM_TOL = 1e-2
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
# flash_attention's f32 products run as 3xTF32 on the tensor cores: three
# TF32 products (495 TFLOP/s dense) for each f32 one
TF32X3_OPS = 495e12 / 3

DEVICE = "cuda"
# phase 7c: paged serving behind the Scheduler (a fixed cost model, so the
# schedule is deterministic; SLOs generous enough that nothing is shed)
SCHED = {"max_batch": 8, "cache_len": 192, "chunk": 64, "horizon": 1.75,
         "paged": {"page_size": 16, "num_pages": 72},
         "cost": {"decode_step_s": 0.02, "prefill_token_s": 2e-4,
                  "prefill_base_s": 2e-3},
         # the controlled run: the same arrivals and prompts with SLOs that
         # bind (the objective is deadline-met goodput, and deadlines end the
         # run a few windows after the last request)
         "control_s": 0.25, "control_slo": {"slo_ttft_s": 0.5,
                                            "slo_tpot_s": 0.04},
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
# phase 8b: the ScaDLES trainer (16 devices as in the paper's example);
# card against CPU, round by round.  The host side is the same numpy code,
# so every host field must be identical.  cuBLAS and the CPU's BLAS sum the
# products in different orders (TF32 off), which moves a round's loss by a
# few ulps; top-k is discontinuous in its input, so an entry within f32
# noise of the k-th magnitude may be kept on one side only, moving that
# parameter by lr * |g_k| (the CPU tests see up to 5.9e-4 against the
# reference, tests/test_torch_scadles.py)
SCADLES = {"n_devices": 16, "rounds": 30, "timed_rounds": 12}
SCADLES_TOL = {"loss_rel": 1e-4, "loss_abs": 1e-6,
               "param_abs": {False: 1e-5, True: 2e-3}}   # keyed: compressed
# phase 8c: the non-IID data plane, card against CPU at SCADLES_TOL.  (b)
# is the non-IID sweep's regime (alpha 0.05, lr 0.15): commits are one- or
# two-class updates at a high learning rate, so f32 noise grows round by
# round.  The round counts were fixed before any card run at 48 (semi-sync
# k 8) and 128 (async).  On the H100 the semi-sync run departed from the
# param limit: the card-vs-CPU param gap by round was 1.9e-8, 1.2e-6,
# 2.4e-6, 3.4e-6, 5.7e-6, 8.9e-6, 1.2e-5 (round 7), then 2.0e-5 (10),
# 3.4e-5 (20), 4.2e-5 (48), with every host field identical and the loss
# within its limit throughout.  The async run kept its params within 4.9e-6
# over 128 rounds, but its per-commit loss (one device's batch) left the
# loss limit at round 114 (0.0141781 on the card, 0.0141823 on the CPU);
# its worst relative loss error in each 8 rounds was 2e-7 to 8.6e-6 up to
# round 72, then 1.9e-3 to 2.4e-3 in rounds 73-96 (at losses of 1e-5 to
# 1e-3).  The limits stay; the runs are held where they keep them with
# room: semi-sync at 5 rounds (eval every round, 8 committed gradients;
# its gap 5.7e-6) and async at 64 (eval every 16; gap 4.9e-6, loss error
# at most 8.6e-6 relative).
STREAMDATA = {"n_devices": 16, "rounds": 30, "timed_rounds": 12,
              "eval_target": 0.1,
              "sweep": {"semi-sync": (5, 1, {"semi_sync_k": 8}),
                        "async": (64, 16, {})},
              "max_buffer": 96,
              "diurnal": {"day_s": 40.0, "amplitude": 0.9},
              "rotate": {"t_scale": 30.0, "w_max": 0.8}}
# phase 8d: the paper CNN, card (f32 convolutions) against the CPU
CNN = {"batch": 128, "seed": 0, "iters": 5,
       "logit_rel": 1e-4, "loss_rel": 1e-5, "grad_rel": 1e-4}
# phases 6b, 6c, 7e: the MoE and hybrid families at full width, random f32
# weights from seed 0.  "layers" cuts depth (None: full depth); mixtral's
# 56 layers come to about 524 GiB in f32, more than one card holds, so it
# keeps 2.  Kernel path against plain path at LOGIT_TOL: the logits of
# these random models are O(1)-O(10) (tied or 1/sqrt(d) heads over rms-
# normed states), so f32 attention-order noise of ~1e-6 relative stays far
# inside 1e-3 absolute.
ZOO = {"recurrentgemma-2b": {"layers": None}, "mixtral-8x22b": {"layers": 2}}
ZOO_OFFLINE = {"batch": 8, "prompt": 128, "gen": 16}
# phase 6c: a prompt past recurrentgemma's 2 048-token local window
ZOO_RING = {"batch": 1, "prompt": 2112, "gen": 16}
# phase 7e: recurrentgemma paged behind the Scheduler, phase 7c's trace
# (no templates: this family shares no prefix) over 4 slots; phase 7f: the
# same for xlstm-125m
ZOO_PAGED = {"max_batch": 4, "cache_len": 192, "page_size": 16,
             "num_pages": 48}
# phases 6d, 6e, 6f: the rest of the zoo at full width and depth, offline
# at ZOO_OFFLINE, with the f32 params the reference's init_params shapes
# give (a check that the widths are the registry's).  xlstm-125m launches
# no kernel (its blocks are plain PyTorch, as the reference's are plain
# jnp), so its card run is held against the CPU; whisper-base (its 1 536
# encoder frames from the launcher's audio stream) and qwen2-vl-2b (text,
# 1-D RoPE, as the reference serves it) against the plain path on the card
ZOO_REST = ("xlstm-125m", "whisper-base", "qwen2-vl-2b")
ZOO_PARAMS = {"xlstm-125m": 77_627_184, "whisper-base": 83_263_488,
              "qwen2-vl-2b": 1_543_714_304}
TRAIN = {"arch": "qwen2-0.5b", "batch": 8, "seq": 256, "loss_chunk": 128,
         "cr": 0.1, "momentum": 0.9, "lr": 1e-3, "seed": 0}
# phase 8e: the training launcher.  (a) n_micro 2 against 1 at the
# reference's own bar (tests/test_models_smoke.py); (b) the launcher's
# program at full width; (c) the same argv at 3 steps of batch 2 on the
# card and on the CPU from the same params: losses to rel 1e-4 and lr equal;
# params within 2 * sum(lr_t), the most two Adam runs can part (its early
# update is ~lr * sign(g), so an element whose gradient sits at f32
# rounding level may step +lr on one side and -lr on the other), and under
# a 1e-4 share of elements more than 1e-5 apart
MICRO_TOL = {"rtol": 2e-4, "atol": 2e-5}
LAUNCH_ARGV = ["--arch", "qwen2-0.5b", "--steps", "20", "--batch", "16",
               "--seq", "128", "--scadles"]
LAUNCH_CPU = {"steps": 3, "batch": 2}
LAUNCH_TOL = {"loss_rel": 1e-4, "param_flip": 1e-5, "flip_share": 1e-4}
# phase 8f: the chunked flash (the training attention) at qwen2-0.5b's head
# layout, f32, chunks of 128 as the launcher takes them (min(128, seq));
# card against CPU at the CPU tests' bars against the reference (forward
# 1e-5; gradients of sum(sin(o)) 1e-4 rel + 1e-5), then one forward +
# backward at 2 x 4 096 in turns with the full path
FLASH_TRAIN = {"heads": 14, "kv": 2, "hd": 64, "batch": 2, "seq": 512,
               "long_seq": 4096, "chunk": 128, "seed": 0,
               "cases": (("causal", 0), ("swa", 256)),
               "fwd_tol": 1e-5, "grad_rtol": 1e-4, "grad_atol": 1e-5}
# phase 8g: the launcher at full width and depth on a long sequence
LONG_ARGV = ["--batch", "2", "--seq", "4096", "--steps", "3", "--scadles"]
# phase 8i: the examples' counterparts on the card, (label, example, argv);
# the "held" ones also run with --device cpu at the same time, and their
# lines must match, losses and accuracies within acc_tol (one unit of the
# printed .3f)
EXAMPLES = {"card": (("quickstart", "quickstart", []),
                     ("train_e2e", "train_e2e", []),
                     ("train_e2e --full", "train_e2e",
                      ["--full", "--steps", "5"]),
                     ("serve_batched", "serve_batched", []),
                     ("scadles_streaming", "scadles_streaming", []),
                     ("scadles_streaming dirichlet", "scadles_streaming",
                      ["--skew", "dirichlet"]),
                     ("fleet_churn", "fleet_churn", [])),
            "held": ("scadles_streaming", "scadles_streaming dirichlet",
                     "fleet_churn"),
            "ckpt": {"train_e2e": "xlstm-125m-reduced.npz",
                     "train_e2e --full": "xlstm-125m.npz"},
            "acc_tol": 1e-3, "timeout_s": 420}
# phase 8j: the sharded training step, qwen2-0.5b at full width and depth
# (phase 8's params and batch, uniform sample weights) on a one-rank NCCL
# group's (1, 1) mesh, `steps` steps at n_micro 1 and 2, against the same
# steps without a mesh at TRAIN_TOL (every collective is the identity on one
# rank), then timed in turns with the unsharded step (`turn_steps` steps a
# turn after one untimed step of each).  No two-rank phase: on
# one card NCCL refuses two ranks, and gloo's all-gather of CUDA tensors
# through the functional collectives DTensor uses ends the process (SIGSEGV,
# torch 2.11; PERF.md §7)
SHARDED = {"steps": 2, "turn_steps": 3}
# phase 8k: the counting layer (phase 8e's step counted, then timed: one
# untimed step and `turn_steps` timed; the dry runs' shapes and time limit)
COUNT = {"turn_steps": 3, "dryruns": ("train_4k", "decode_32k"),
         "timeout_s": 300}
# repro.dist.calibrate("qwen1.5-0.5b", n, cr, reduced=True) under jax 0.9.0
# on the CPU (the card's host has no jax; tests/test_torch_calibrate.py
# holds the port against it live): (n, cr) -> (n_floats, k, dense and
# compressed wire bytes)
REF_CALIBRATION = {(2, 0.25): (1_575_680, 393_920, 6_302_728.0, 3_151_372.0),
                   (4, 0.1): (1_575_680, 157_568, 9_454_092.0, 3_781_650.0)}
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "attn_mode",
               "flops_per_chip", "bytes_per_chip", "flop_counter_raw",
               "collective", "memory", "roofline", "model_flops_per_chip",
               "useful_flops_ratio", "params_total", "params_active",
               "n_micro", "grad_wire_bf16", "compile_s")
# phase 8l: sharded serving on a one-rank mesh (phase 6's run), the lse
# output of flash_decode at (b, S, h, kv, hd, kv_len per slot), and one dry
# run for each class of combination that DTensor refused before the port
# ran its sharded programs on local shards (ROADMAP.md §3): (class, arch,
# shape)
LSE_CASES = {"qwen2-0.5b": (8, 160, 14, 2, 64,
                            [160, 1, 0, 63, 64, 65, 100, 159]),
             "recurrentgemma-2b b 1": (1, 2048, 10, 1, 256, [2048]),
             "recurrentgemma-2b b 8": (8, 2048, 10, 1, 256,
                                       [2048, 0, 1, 255, 256, 257, 1500,
                                        2047])}
DRYRUN_CLASSES = (("A", "internlm2-20b", "train_4k"),
                  ("B", "internlm2-20b", "decode_32k"),
                  ("C", "qwen2-0.5b", "long_500k"),
                  ("D", "qwen2-vl-2b", "prefill_32k"),
                  ("E", "xlstm-125m", "decode_32k"))
DRYRUN_TIMEOUT_S = 420
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


def build(build_mod, fa) -> None:
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
    check_no_spills(build_mod.lib_path("flash_decode").with_suffix(".log"),
                    "flash_decode_kernel")
    fa_log = build_mod.lib_path("flash_attention").with_suffix(".log")
    regs = check_no_spills(fa_log, "flash_fwd")
    # the f32 hd-256 instance (template arguments <float, 256, 1>), split
    # over a cluster of two blocks
    split = [r for name, r in regs.items() if "flash_fwd_wgmmaIfLi256E" in name]
    lib = build_mod.load("flash_attention", fa._ARGTYPES)
    smem = lib.flash_attention_smem(256, 0, 64)
    log(f"#   flash_fwd_wgmma<float, 256, 1> (a cluster of two blocks): "
        f"{split} registers, {smem} bytes of dynamic shared memory a block")
    if len(split) != 1 or smem <= 0:
        fail("no f32 hd-256 instance of flash_fwd_wgmma in the ptxas report")


def check_no_spills(report: Path, kernel: str) -> dict:
    """Fail if ptxas reports a spill for any instance of ``kernel`` in a
    library's build log (``-Xptxas -v``: a "Function properties for
    <name>" line, then its stack frame and spill bytes).  Returns each
    instance's registers by mangled name."""
    if not report.exists():
        fail(f"no ptxas report {report.name} beside the library")
    name, n, spilled, regs = "", 0, [], {}
    for line in report.read_text().splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
        elif kernel not in name:
            continue
        elif "spill stores" in line:
            n += 1
            if " 0 bytes spill stores, 0 bytes spill loads" not in line:
                spilled.append(f"{name}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            regs[name] = int(line.split("Used")[1].split()[0])
    log(f"#   {kernel}: {n} instances, {len(spilled)} with spills, "
        f"{min(regs.values(), default=0)}-{max(regs.values(), default=0)} "
        "registers")
    if n == 0 or spilled:
        fail(f"{kernel} spills registers (or ptxas reported no instance): "
             f"{spilled[:4]}")
    return regs


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
        # the long prompt, and a scheduler chunk at its end
        ("long prompt", 1, LONG_PROMPT, LONG_PROMPT, 14, 2, 64, "causal", 0,
         0, "float32"),
        ("long prompt", 1, LONG_PROMPT, LONG_PROMPT, 14, 2, 64, "causal", 0,
         0, "bfloat16"),
        ("chunk at the end", 1, 64, LONG_PROMPT, 14, 2, 64, "causal", 0,
         LONG_PROMPT - 64, "float32"),
        # internlm2's grouping (h 48, kv 8, hd 128), ragged
        ("hd128 g6 ragged", 1, 200, 200, 48, 8, 128, "causal", 0, 0,
         "float32"),
        ("hd128 g6 ragged", 1, 200, 200, 48, 8, 128, "causal", 0, 0,
         "bfloat16"),
        # the shapes of phases 6b, 6c and 7e: recurrentgemma-2b's local
        # attention (f32 hd 256, split over a cluster) and mixtral-8x22b's
        # SWA
        ("recurrentgemma prefill", 8, 128, 128, 10, 1, 256, "swa", 2048, 0,
         "float32"),
        ("recurrentgemma past the window", 1, 2112, 2112, 10, 1, 256, "swa",
         2048, 0, "float32"),
        ("recurrentgemma chunk", 1, 64, 192, 10, 1, 256, "swa", 2048, 128,
         "float32"),
        # more of the split f32 hd-256 body: a ragged bidir tile, a causal
        # q_offset on a key-tile edge, a chunk past the window
        ("hd256 bidir ragged", 1, 130, 130, 10, 1, 256, "bidir", 0, 0,
         "float32"),
        ("hd256 causal+q_offset on a tile edge", 2, 96, 160, 10, 1, 256,
         "causal", 0, 64, "float32"),
        ("hd256 chunk past the window", 1, 64, 4096, 10, 1, 256, "swa", 2048,
         4032, "float32"),
        ("mixtral prefill", 8, 128, 128, 48, 8, 128, "swa", 4096, 0,
         "float32"),
        # phase 6e: whisper-base (h 8 = kv 8, hd 64, f32): the encoder's
        # bidir 1 536 x 1 536, the cross-attention of a 128-token prompt
        # and of a ragged chunk over the 1 536 frames; phase 6f:
        # qwen2-vl-2b's prefill (hd 128, g 6)
        ("whisper encoder", 8, 1536, 1536, 8, 8, 64, "bidir", 0, 0,
         "float32"),
        ("whisper cross", 8, 128, 1536, 8, 8, 64, "bidir", 0, 0, "float32"),
        ("whisper cross ragged", 2, 77, 1536, 8, 8, 64, "bidir", 0, 0,
         "float32"),
        ("whisper self", 8, 128, 128, 8, 8, 64, "causal", 0, 0, "float32"),
        ("qwen2-vl prefill", 8, 128, 128, 12, 2, 128, "causal", 0, 0,
         "float32"),
        # phase 8i: serve_batched_torch.py's reduced recurrentgemma-2b (h 4,
        # kv 1, hd 64, f32, swa window 64): a 16-token prompt, the cost
        # model's 8-token probe, and a chunk of a prompt at its q_offset
        ("serve_batched prompt", 1, 16, 16, 4, 1, 64, "swa", 64, 0,
         "float32"),
        ("serve_batched probe", 1, 8, 8, 4, 1, 64, "swa", 64, 0, "float32"),
        ("serve_batched chunk", 1, 8, 16, 4, 1, 64, "swa", 64, 8,
         "float32"),
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
        same_twice(torch, out, lambda: fa.flash_attention(
            q, k, v, kind=kind, window=window, q_offset=off))
        del q, k, v, out, ref
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
        # the split-K geometry: kv_len at the split edges of a long context
        ("S 16384, split edges", 10, 16384, 14, 2, 64,
         split_lens(fd, 10, 2, 16384), "float32"),
        ("S 16384, split edges", 10, 16384, 14, 2, 64,
         split_lens(fd, 10, 2, 16384), "bfloat16"),
        ("S 16484, not a multiple of the split", 10, 16484, 14, 2, 64,
         split_lens(fd, 10, 2, 16484), "float32"),
        ("S 1000, 8 splits of 128", 3, 1000, 14, 2, 64, [1000, 129, 0],
         "float32"),
        ("g 16, hd 64", 4, 700, 32, 2, 64, [700, 1, 333, 0], "float32"),
        ("g 16, hd 256", 2, 300, 16, 1, 256, [300, 97], "float32"),
        ("g 16, hd 256", 2, 300, 16, 1, 256, [300, 97], "bfloat16"),
        # phases 6b and 6c: recurrentgemma-2b, mixtral-8x22b
        ("recurrentgemma decode", 8, 144, 10, 1, 256,
         [129, 130, 133, 137, 140, 141, 143, 144], "float32"),
        ("recurrentgemma full ring", 1, 2048, 10, 1, 256, [2048],
         "float32"),
        ("mixtral decode", 8, 144, 48, 8, 128,
         [129, 130, 133, 137, 140, 141, 143, 144], "float32"),
        # phases 6e, 6f: whisper-base's cross-attention over its 1 536
        # frames (S = kv_len, g 1, hd 64) at b 8 and b 1, its and
        # qwen2-vl-2b's self-attention (hd 128, g 6)
        ("whisper cross", 8, 1536, 8, 8, 64, [1536] * 8, "float32"),
        ("whisper cross, b 1", 1, 1536, 8, 8, 64, [1536], "float32"),
        ("whisper self", 8, 144, 8, 8, 64,
         [129, 130, 133, 137, 140, 141, 143, 144], "float32"),
        ("qwen2-vl decode", 8, 144, 12, 2, 128,
         [129, 130, 133, 137, 140, 141, 143, 144], "float32"),
        # phase 8i: serve_batched_torch.py's 4 slots of 16 + 32 (g 4, hd
        # 64, f32): a slot just filled beside fresh ones, mixed ages, the
        # cache full
        ("serve_batched decode", 4, 48, 4, 1, 64, [17, 1, 1, 1], "float32"),
        ("serve_batched decode", 4, 48, 4, 1, 64, [1, 17, 35, 48],
         "float32"),
        ("serve_batched decode", 4, 48, 4, 1, 64, [48] * 4, "float32"),
    ]
    for (label, b, S, h, kv, hd, lens, dt) in dec_cases:
        q = rand(torch, (b, 1, h, hd), dts[dt], gen)
        kc = rand(torch, (b, S, kv, hd), dts[dt], gen)
        vc = rand(torch, (b, S, kv, hd), dts[dt], gen)
        kvl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        out = fd.flash_decode(q, kc, vc, kvl)
        ref = fd.flash_decode_ref(q, kc, vc, kvl)
        compare(torch, f"flash_decode {label} q{(b, 1, h, hd)} "
                f"cache{(b, S, kv, hd)} kv_len={lens} {dt} split "
                f"{fd.split_geometry(b, kv, S)}", out, ref, dt,
                errs["flash_decode"])
        same_twice(torch, out, lambda: fd.flash_decode(q, kc, vc, kvl))
        del q, kc, vc, out, ref
    errs["flash_decode_paged"] = check_paged(torch, fd, gen, dts)
    return {name: max(e for d, e in es if d == "float32")
            for name, es in errs.items()}


def split_lens(fd, b, kvh, S):
    """kv_len values at the split edges of (b, kvh, S), b of them (b >= 10):
    0, 1, the first split size - 1, it, + 1, the second boundary - 1 and
    + 1, a mid value, S - 1 and S, then full rows."""
    _, kps = fd.split_geometry(b, kvh, S)
    lens = [0, 1, kps - 1, kps, kps + 1, 2 * kps - 1, 2 * kps + 1,
            S // 2 + 7, S - 1, S]
    return (lens + [S] * b)[:b]


def same_twice(torch, out, again):
    """A second call on the same inputs gives the same bits."""
    second = again()
    torch.cuda.synchronize()
    if not same_bits(torch, out, second):
        fail("two calls on the same inputs differ")


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
        # the split geometry through pages of 16 and 5 (S 16385: 3277
        # pages of 5; no whole number of 5-token pages makes 16384)
        ("S 16384, pages of 16", 10, 16, 1024, 10280, 14, 2, 64,
         split_lens(fd, 10, 2, 16384), "float32", "scrambled"),
        ("S 16384, pages of 16", 10, 16, 1024, 10280, 14, 2, 64,
         split_lens(fd, 10, 2, 16384), "bfloat16", "scrambled"),
        ("S 16385, pages of 5", 10, 5, 3277, 33000, 14, 2, 64,
         split_lens(fd, 10, 2, 16385), "float32", "scrambled"),
        ("g 16, hd 256", 2, 16, 20, 45, 16, 1, 256, [320, 97], "float32",
         "scrambled"),
        # phase 7e: recurrentgemma-2b's 4 slots, pages of 16
        ("recurrentgemma slots", 4, 16, 12, 52, 10, 1, 256,
         [17, 64, 128, 160], "float32", "scrambled"),
        # whisper-base's paged self-attention (g 1, hd 64), pages of 16
        ("whisper slots", 4, 16, 12, 52, 8, 8, 64, [17, 64, 128, 160],
         "float32", "scrambled"),
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
        same = same_bits(torch, out, fd.flash_decode(q, *view, kvl))
        log(f"    bit-identical to flash_decode on the gathered view: "
            f"{same}")
        if not same:
            fail("flash_decode_paged differs from flash_decode on the same "
                 "keys")
        same_twice(torch, out,
                   lambda: fd.flash_decode_paged(q, kp, vp, bt, kvl))
        del q, kp, vp, bt, out, ref, view
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


def scheduled_run(rt, cfg, ctx, params, cost, reqs, runner_kw,
                  controller=None, max_batch=SCHED["max_batch"],
                  cache_len=SCHED["cache_len"]):
    """One run of the trace through a ``SlotRunner`` behind the
    ``Scheduler`` (chunk 64, decode_first), counting the prefill chunks
    and decode steps the runner makes; returns (runner, records, summary,
    counts, wall s)."""
    runner = rt.SlotRunner(params, cfg, ctx, max_batch, cache_len,
                           **runner_kw)
    sched = rt.Scheduler(max_batch, cost, runners=[runner],
                         chunk_tokens=SCHED["chunk"], priority="decode_first")
    n = {"chunks": 0, "steps": 0}
    chunk, step = sched._prefill_chunk, runner.step

    def counted_chunk(lane, now):
        n["chunks"] += 1
        return chunk(lane, now)

    def counted_step(active):
        n["steps"] += 1
        return step(active)

    sched._prefill_chunk, runner.step = counted_chunk, counted_step
    ctl = ({} if controller is None else
           {"controller": controller, "control_every_s": SCHED["control_s"],
            "window_s": SCHED["control_s"]})
    t0 = time.perf_counter()
    recs, summary = sched.run(reqs, horizon_s=SCHED["horizon"], **ctl)
    return runner, recs, summary, n, time.perf_counter() - t0


def hold_scheduled(label, cfg, runner, recs, summary):
    """Conservation, every completed request with all its tokens, and the
    page pool conserved."""
    done = [r for r in recs if r.completed]
    if not summary["conservation_ok"]:
        fail(f"{label}: a request reached no single terminal state")
    if not done or any(len(runner.generated[r.rid]) != r.target_tokens
                       or not all(0 <= t < cfg.vocab_size for t in
                                  runner.generated[r.rid])
                       for r in done):
        fail(f"{label}: completed requests lack their tokens")
    if runner.pool is not None and not runner.pool.conserved():
        fail(f"{label}: page pool not conserved")
    return done


def serve_scheduled(torch, mods, serve, rt):
    """Phase 7c: paged serving behind the Scheduler at full width, with
    prefix sharing off and on, against a fixed-slot runner on the same
    trace and a fixed cost model (so the schedule is deterministic); then
    the paged run under a ``ServeController``, whose actions must equal
    those of the same controlled schedule on the CPU at reduced depth."""
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
        reset(mods)
        runner, recs, summary, n, wall = scheduled_run(
            rt, cfg, ctx, params, cost, reqs, kw)
        torch.cuda.synchronize()
        launched = counts(mods)
        for name in total:
            total[name] += launched[name]
        decode = ("flash_decode_paged" if runner.pool is not None
                  else "flash_decode")
        want = expect(flash_attention=n["chunks"] * cfg.num_layers,
                      **{decode: n["steps"] * cfg.num_layers})
        share = summary.get("prefix_sharing") or {}
        done = hold_scheduled(label, cfg, runner, recs, summary)
        log(f"  {label}: {n['chunks']} prefill chunks, {n['steps']} decode "
            f"steps, {wall:.2f} s wall; conservation_ok "
            f"{summary['conservation_ok']}; completed {len(done)}/"
            f"{len(recs)}; launches {launched}"
            + (f"; prefix hits {share['hits']}/{share['lookups']}, prefill "
               f"tokens skipped {share['prefill_tokens_skipped']}, pages "
               f"saved {share['pages_saved']}/{share['pages_asked']}"
               if share else ""))
        if launched != want:
            fail(f"{label}: launched {launched}, expected {want}")
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
    controlled = serve_controlled(torch, mods, serve, rt, cfg, ctx, params,
                                  cost)
    for name in total:
        total[name] += controlled[name]
    return total


def serve_controlled(torch, mods, serve, rt, cfg, ctx, params, cost):
    """Phase 7c's controlled run: the paged runner (sharing off) behind the
    Scheduler with a ``ServeController`` ticking every window.  Under the
    fixed cost model the schedule, and so the controller's actions, depend
    on the trace, the pages and the batch size, not on the tokens: the
    same run on the CPU at reduced depth must act alike."""
    reqs = rt.RequestStream(**dict(SCHED["stream"], **SCHED["control_slo"])
                            ).generate(SCHED["horizon"])
    reset(mods)
    ctrl = rt.ServeController()
    runner, recs, summary, n, wall = scheduled_run(
        rt, cfg, ctx, params, cost, reqs, SCHED["paged"], controller=ctrl)
    torch.cuda.synchronize()
    launched = counts(mods)
    label = "paged, sharing off, ServeController"
    done = hold_scheduled(label, cfg, runner, recs, summary)
    want = expect(flash_attention=n["chunks"] * cfg.num_layers,
                  flash_decode_paged=n["steps"] * cfg.num_layers)
    actions = [dataclasses.astuple(a) for a in ctrl.actions]
    log(f"  {label} (control every {SCHED['control_s']:g} s of a "
        f"{SCHED['control_s']:g} s window; SLOs TTFT "
        f"{SCHED['control_slo']['slo_ttft_s']:g} s, TPOT "
        f"{SCHED['control_slo']['slo_tpot_s']:g} s): {n['chunks']} prefill "
        f"chunks, "
        f"{n['steps']} decode steps, {wall:.2f} s wall; conservation_ok "
        f"{summary['conservation_ok']}; completed {len(done)}/{len(recs)}; "
        f"launches {launched}; goodput {summary['goodput_tok_s']:.1f} tok/s "
        f"sim; final knobs chunk {summary['chunk_tokens']}, "
        f"{summary['priority']}, {summary['active_runners']} runner(s); "
        f"{len(actions)} actions, the first {min(len(actions), 8)}: "
        f"{actions[:8]}")
    if launched != want:
        fail(f"{label}: launched {launched}, expected {want}")
    if not actions:
        fail(f"{label}: the controller took no action")
    for _, axis, value, _ in actions:
        on_axis = {"chunk_tokens": value in ctrl.chunk_grid,
                   "priority": value in rt.PRIORITIES,
                   "active_runners": value == 1}[axis]
        if not on_axis:
            fail(f"{label}: action {axis}={value!r} off its axis")
    cpu_args = serve.parse_args(SERVE_ARGV + ["--reduced", "--device", "cpu"])
    cpu_cfg, cpu_ctx, cpu_params, _, _ = serve.setup(cpu_args)
    cpu_ctrl = rt.ServeController()
    _, cpu_recs, cpu_summary, cpu_n, _ = scheduled_run(
        rt, cpu_cfg, cpu_ctx, cpu_params, cost, reqs, SCHED["paged"],
        controller=cpu_ctrl)
    cpu_actions = [dataclasses.astuple(a) for a in cpu_ctrl.actions]
    if cpu_actions != actions or cpu_n != n or cpu_summary != summary:
        fail(f"{label}: the CPU run at reduced depth acted otherwise: "
             f"{cpu_actions} ({cpu_n}) against {actions} ({n})")
    log(f"  the same controlled schedule on the CPU at reduced depth "
        f"({cpu_cfg.num_layers} layers, d_model {cpu_cfg.d_model}): the "
        "same actions, chunks, steps and summary")
    return launched


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
# phases 6b, 6c, 7e: the MoE and hybrid families


def zoo_cfg(get_config, arch):
    """The config phases 6b-6f, 7e and 7f serve: the registry's, at full
    width, with depth cut where ZOO says (mixtral's 56 layers are ~524 GiB
    in f32); every other arch at full depth."""
    cfg = get_config(arch)
    layers = ZOO.get(arch, {}).get("layers")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  layer_pattern=cfg.pattern[:layers])
    return cfg


def n_attention(cfg) -> int:
    """Attention layers of ``cfg``: one kernel launch each per prefill
    chunk and per decode step."""
    from repro_torch.models.transformer import ATTN_KINDS
    return sum(kind in ATTN_KINDS for kind in cfg.pattern)


def per_pass(cfg):
    """(``flash_attention`` launches of an offline prefill, ``flash_decode``
    launches of a decode step) for ``cfg``: one each per attention layer;
    whisper adds one each per decoder layer for the cross-attention and,
    at prefill, one per encoder layer (``prefill_cross_kv``)."""
    n_attn = n_attention(cfg)
    n_cross = cfg.num_layers if cfg.encoder_layers else 0
    return n_attn + n_cross + cfg.encoder_layers, n_attn + n_cross


def zoo_argv(arch, batch, prompt, gen):
    return ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen", str(gen), "--temperature", "0", "--seed",
            "0", "--device", DEVICE]


def plain_greedy(torch, dec, cfg, ctx, params, prompts, gen, feats=None):
    """The offline run on the plain versions, greedy: (tokens (b, gen),
    prefill logits, last logits, cache); ``feats``: whisper's encoder
    frames, run through ``prefill_cross_kv`` first."""
    tctx = dataclasses.replace(ctx, prefill_backend="torch",
                               decode_backend="torch")
    cache = dec.init_cache(cfg, prompts.shape[0], prompts.shape[1] + gen,
                           tctx)
    if feats is not None:
        cache = dec.prefill_cross_kv(params, feats, cfg, tctx, cache)
    logits, cache = dec.prefill_cache(params, prompts, cache, cfg, tctx)
    first, out = logits, []
    for _ in range(gen):
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
        logits, cache = dec.decode_step(params, cache, nxt[:, None], cfg,
                                        tctx)
    return torch.stack(out, dim=1), first, logits, cache


def zoo_offline(torch, mods, serve, dec, get_config, arch, batch, prompt,
                gen, label):
    """One offline run of ``arch`` through ``run_offline`` on the kernel
    path, counted (:func:`per_pass`), then the same prompts (and frames)
    greedily on the plain path: equal tokens, logits after prefill and
    after the last step within LOGIT_TOL.  Returns (launches, the plain
    run's cache, cfg)."""
    from repro_torch.tree import leaves
    cfg = zoo_cfg(get_config, arch)
    args = serve.parse_args(zoo_argv(arch, batch, prompt, gen))
    pre, step = per_pass(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset(mods)
    t0 = time.perf_counter()
    res = serve.run_offline(args, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts(mods)
    enc = (f"{cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_seq_len} frames (encode {res['encode_s']:.3f} s), "
           if cfg.encoder_layers else "")
    log(f"  {label}: {cfg.num_layers} layers ({n_attention(cfg)} attention)"
        f", {enc}d_model {cfg.d_model}, vocab {cfg.vocab_size}; batch "
        f"{batch}, prompt {prompt}, {gen} greedy tokens; run_offline "
        f"{wall:.2f} s wall (prefill {res['prefill_s']:.3f} s, decode "
        f"{res['decode_s']:.3f} s), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; "
        f"launches {launched}")
    want = expect(flash_attention=pre, flash_decode=step * gen)
    if launched != want:
        fail(f"{label}: launched {launched}, expected {want}")
    for key in ("prefill_logits", "last_logits"):
        if not torch.isfinite(res[key]).all():
            fail(f"{label}: {key} not finite")
    if res["tokens"].shape != (batch, gen):
        fail(f"{label}: tokens shape {tuple(res['tokens'].shape)}")
    cfg, ctx, params, prompts, _ = serve.setup(args, cfg)
    if not torch.equal(prompts, res["prompts"]):
        fail(f"{label}: prompts differ between two setups from one seed")
    n_params = sum(p.numel() for p in leaves(params))
    if arch in ZOO_PARAMS and n_params != ZOO_PARAMS[arch]:
        fail(f"{label}: {n_params} params, the reference's shapes give "
             f"{ZOO_PARAMS[arch]}")
    toks, first, last, cache = plain_greedy(torch, dec, cfg, ctx, params,
                                            prompts, gen, res["audio_feats"])
    same = torch.equal(toks, res["tokens"])
    err_prefill = max_err(res["prefill_logits"], first)
    err_last = max_err(res["last_logits"], last)
    log(f"  {label} vs the plain path ({n_params} f32 params): greedy "
        f"tokens equal {same}; logits after prefill max_abs_err="
        f"{err_prefill:.3e}, after step {gen} max_abs_err={err_last:.3e} "
        f"(|logits| max {float(last.abs().max()):.3f}), bound "
        f"{LOGIT_TOL:g}")
    if not same:
        fail(f"{label}: greedy tokens differ from the plain path")
    if not (err_prefill <= LOGIT_TOL and err_last <= LOGIT_TOL):
        fail(f"{label}: logits disagree with the plain path")
    del params, res
    return launched, cache, cfg


def serve_zoo(torch, mods, serve, dec, get_config):
    """Phases 6b and 6c: recurrentgemma-2b at full width and depth and
    mixtral-8x22b at full width and depth 2, offline; then recurrentgemma
    with a prompt longer than its 2 048-token local window, so the ring
    wraps at prefill and through decode."""
    log("# phase 6b: offline serving of the MoE and hybrid families at full "
        "width")
    launched = {}
    for arch in ZOO:
        launched[arch], cache, _ = zoo_offline(
            torch, mods, serve, dec, get_config, arch, **ZOO_OFFLINE,
            label=arch)
        del cache
        torch.cuda.empty_cache()
    log("# phase 6c: recurrentgemma-2b with the local-attention ring "
        "wrapping at full width")
    arch = "recurrentgemma-2b"
    launched["recurrentgemma-2b ring"], cache, cfg = zoo_offline(
        torch, mods, serve, dec, get_config, arch, **ZOO_RING,
        label=f"{arch} ring")
    rings = {cl["k"].shape[-3] for part in ("unit", "rest")
             for cl in cache[part].values() if "k" in cl}
    ring = min(cfg.window_size, ZOO_RING["prompt"] + ZOO_RING["gen"])
    log(f"  ring length {ring} (window {cfg.window_size}) under a "
        f"{ZOO_RING['prompt']}-token prompt and {ZOO_RING['gen']} steps; "
        f"cache rings {sorted(rings)}; final pos {int(cache['pos'])}")
    if rings != {ring} or not ZOO_RING["prompt"] > ring:
        fail("phase 6c: the local-attention ring did not wrap")
    del cache
    torch.cuda.empty_cache()
    return launched


def xlstm_on_cpu(torch, mods, serve, dec, get_config, arch, batch, prompt,
                 gen, label):
    """Phase 6d: ``arch`` offline through ``run_offline`` on the card,
    counted (no kernel may launch), then the same params and prompts,
    copied to the CPU, there: prefill, then decode teacher-forced on the
    card's tokens.  Logits after prefill and at every step within
    XLSTM_TOL; every card token the CPU's argmax wherever the CPU's top-2
    gap exceeds 2 XLSTM_TOL; the CPU's free greedy run and its spread
    under a one-ulp change of the params printed beside.  The card and the
    CPU run the same code here, so the CPU is the yardstick."""
    from repro_torch.tree import leaves, tree_map
    cfg = zoo_cfg(get_config, arch)
    args = serve.parse_args(zoo_argv(arch, batch, prompt, gen))
    torch.cuda.reset_peak_memory_stats()
    reset(mods)
    t0 = time.perf_counter()
    res = serve.run_offline(args, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts(mods)
    log(f"  {label}: {cfg.num_layers} layers ({cfg.pattern.count('mlstm')} "
        f"mLSTM, {cfg.pattern.count('slstm')} sLSTM; {cfg.num_heads} heads "
        f"of {cfg.resolved_head_dim}), d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; batch {batch}, prompt {prompt}, {gen} greedy "
        f"tokens; run_offline {wall:.2f} s wall (prefill "
        f"{res['prefill_s']:.3f} s, decode {res['decode_s']:.3f} s), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; "
        f"launches {launched}")
    if launched != expect():
        fail(f"{label}: launched {launched}, expected none")
    cfg, ctx, params, prompts, _ = serve.setup(args, cfg)
    if not torch.equal(prompts, res["prompts"]):
        fail(f"{label}: prompts differ between two setups from one seed")
    n_params = sum(p.numel() for p in leaves(params))
    if n_params != ZOO_PARAMS[arch]:
        fail(f"{label}: {n_params} params, the reference's shapes give "
             f"{ZOO_PARAMS[arch]}")
    cpu = dataclasses.replace(ctx, device="cpu")
    host = tree_map(lambda t: t.cpu(), params)
    del params
    prompts, card_toks = prompts.cpu(), res["tokens"].cpu()
    t0 = time.perf_counter()
    cache = dec.init_cache(cfg, batch, prompt + gen, cpu)
    logits, cache = dec.prefill_cache(host, prompts, cache, cfg, cpu)
    errs = [max_err(res["prefill_logits"].cpu(), logits)]
    first = logits
    wrong, ties, min_gap = 0, 0, float("inf")
    for i in range(gen):
        top2 = torch.topk(logits, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        miss = torch.argmax(logits, -1) != card_toks[:, i]
        wrong += int((miss & (gap > 2 * XLSTM_TOL)).sum())
        ties += int((miss & (gap <= 2 * XLSTM_TOL)).sum())
        min_gap = min(min_gap, float(gap.min()))
        logits, cache = dec.decode_step(host, cache, card_toks[:, i:i + 1],
                                        cfg, cpu)
    errs.append(max_err(res["last_logits"].cpu(), logits))
    cpu_s = time.perf_counter() - t0
    free, _, _, _ = plain_greedy(torch, dec, cfg, cpu, host, prompts, gen)
    g = torch.Generator().manual_seed(3)
    ulp = tree_map(lambda t: t + t * 2.0 ** -23 * torch.sign(
        torch.randn(t.shape, generator=g)), host)
    spread = max_err(first, dec.prefill_cache(
        ulp, prompts, dec.init_cache(cfg, batch, prompt + gen, cpu), cfg,
        cpu)[0])
    log(f"  {label} vs the CPU ({n_params} f32 params; teacher-forced on the "
        f"card's tokens, {cpu_s:.2f} s): logits after prefill max_abs_err="
        f"{errs[0]:.3e}, after step {gen} max_abs_err={errs[1]:.3e} (|logits|"
        f" max {float(logits.abs().max()):.3f}), bound {XLSTM_TOL:g}; card "
        f"tokens the CPU's argmax except {ties} ties within "
        f"{2 * XLSTM_TOL:g} and {wrong} others (smallest top-2 gap "
        f"{min_gap:.3e}); the CPU's free greedy tokens equal the card's: "
        f"{torch.equal(free, card_toks)}; the CPU's own spread, the prefill"
        f" logits under a one-ulp change of every param: {spread:.3e}")
    if wrong:
        fail(f"{label}: {wrong} card tokens are not the CPU's argmax")
    if max(errs) > XLSTM_TOL:
        fail(f"{label}: logits disagree with the CPU's")
    del host, ulp, res
    torch.cuda.empty_cache()
    return launched


def serve_zoo_rest(torch, mods, serve, dec, get_config):
    """Phases 6d, 6e, 6f: xlstm-125m (card against CPU), whisper-base and
    qwen2-vl-2b (kernel path against plain path) offline at full width and
    depth."""
    launched = {}
    for arch, phase in zip(ZOO_REST, ("6d", "6e", "6f")):
        log(f"# phase {phase}: offline serving of {arch} at full width and "
            "depth")
        if arch == "xlstm-125m":
            launched[f"{phase} {arch}"] = xlstm_on_cpu(
                torch, mods, serve, dec, get_config, arch, **ZOO_OFFLINE,
                label=arch)
        else:
            launched[f"{phase} {arch}"], cache, _ = zoo_offline(
                torch, mods, serve, dec, get_config, arch, **ZOO_OFFLINE,
                label=arch)
            del cache
        torch.cuda.empty_cache()
    return launched


def slot_states(torch, dec, cfg, ctx, params, label, layout):
    """The recurrent (RG-LRU) or xLSTM state of every layer at full width
    through the slot functions of ``layout``: "paged" (a paged cache
    through ``slot_insert``/``slot_evict``, which take a cache with a block
    table to ``paged_insert``/``paged_evict``), "paged direct" (a paged
    cache through ``paged_insert``/``paged_evict`` themselves, for a stack
    with no page to map) or "fixed" (``init_slot_cache``): inserted bit for
    bit, other slots untouched, zeroed on eviction."""
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    cache_len, page = ZOO_PAGED["cache_len"], ZOO_PAGED["page_size"]
    per = cache_len // page
    if layout == "fixed":
        cache = dec.init_slot_cache(cfg, 3, cache_len, ctx)
    else:
        cache = dec.init_paged_cache(cfg, 3, cache_len, ctx, page_size=page,
                                     num_pages=3 * per)
    insert, evict = ((dec.paged_insert, dec.paged_evict)
                     if layout == "paged direct"
                     else (dec.slot_insert, dec.slot_evict))
    srcs = []
    for slot, plen in enumerate((17, 64, 33)):
        one = dec.init_cache(cfg, 1, cache_len, ctx)
        one["pos"] = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                               device=DEVICE)
        _, src = dec.prefill_cache(params, prompt, one, cfg, ctx)
        pages = range(slot * per, (slot + 1) * per)
        if layout == "fixed":
            insert(cache, slot, src)
        else:
            insert(cache, slot, src, pages=pages)
        srcs.append(src)
    states = [(part, name, leaf) for part in ("unit", "rest")
              for name, cl in cache[part].items() for leaf in cl
              if leaf not in ("k", "v", "bt", "ck", "cv")]

    def slot_state(c, part, name, leaf, slot):
        t = c[part][name][leaf]
        return t[:, slot] if part == "unit" else t[slot]

    n_layers = sum(cache[part][name][leaf].shape[0] if part == "unit" else 1
                   for part, name, leaf in states if leaf in ("conv", "m"))
    inserted = all(torch.equal(slot_state(cache, *st, slot),
                               slot_state(src, *st, 0))
                   for st in states for slot, src in enumerate(srcs))
    live = all(bool(slot_state(src, *st, 0).any())
               for st in states for src in srcs)
    evict(cache, 1)
    zeroed = all(not bool(slot_state(cache, *st, 1).any()) for st in states)
    kept = all(torch.equal(slot_state(cache, *st, slot),
                           slot_state(srcs[slot], *st, 0))
               for st in states for slot in (0, 2))
    leaves_ = sorted({leaf for _, _, leaf in states})
    log(f"  {label} ({layout}: {insert.__name__}/{evict.__name__}): state "
        f"{leaves_} of {n_layers} layers nonzero {live}, inserted bit for "
        f"bit {inserted}, zeroed on eviction {zeroed}, other slots "
        f"untouched {kept}")
    if not (live and inserted and zeroed and kept):
        fail(f"{label}: state lost in {insert.__name__}/{evict.__name__}")


def serve_zoo_paged(torch, mods, serve, rt, dec, get_config, arch, phase,
                    layouts):
    """Phase 7e (recurrentgemma-2b) or 7f (xlstm-125m): ``arch`` on a paged
    cache through ``SlotRunner`` with ``ChunkedPrefill`` behind the
    Scheduler (fewer slots than requests, so slots are released and taken
    again), against a fixed-slot runner on the same schedule: only
    ``flash_decode_paged`` at decode (none for a stack without attention),
    tokens identical; first its state through the slot functions of each
    of ``layouts`` (:func:`slot_states`)."""
    log(f"# phase {phase}: paged serving of {arch} at full width behind the "
        "Scheduler")
    cfg = zoo_cfg(get_config, arch)
    args = serve.parse_args(zoo_argv(arch, 1, 16, 1))
    cfg, ctx, params, _, _ = serve.setup(args, cfg)
    n_attn = n_attention(cfg)
    for layout in layouts:
        slot_states(torch, dec, cfg, ctx, params, arch, layout)
    cost = rt.StepCostModel(**SCHED["cost"])
    reqs = rt.RequestStream(**dict(SCHED["stream"], n_templates=0,
                                   template_prefix_len=0)
                            ).generate(SCHED["horizon"])
    geom = {"max_batch": ZOO_PAGED["max_batch"],
            "cache_len": ZOO_PAGED["cache_len"]}
    runs = {}
    for label, kw in (("paged", {"page_size": ZOO_PAGED["page_size"],
                                 "num_pages": ZOO_PAGED["num_pages"]}),
                      ("fixed-slot", {})):
        reset(mods)
        runner, recs, summary, n, wall = scheduled_run(
            rt, cfg, ctx, params, cost, reqs, kw, **geom)
        torch.cuda.synchronize()
        launched = counts(mods)
        done = hold_scheduled(f"phase {phase} {label}", cfg, runner, recs,
                              summary)
        decode = "flash_decode_paged" if kw else "flash_decode"
        want = expect(flash_attention=n["chunks"] * n_attn,
                      **{decode: n["steps"] * n_attn})
        log(f"  {label}: {len(recs)} requests over {geom['max_batch']} "
            f"slots, {n['chunks']} prefill chunks, {n['steps']} decode "
            f"steps, {wall:.2f} s wall; completed {len(done)}; launches "
            f"{launched}")
        if launched != want:
            fail(f"phase {phase} {label}: launched {launched}, expected "
                 f"{want}")
        if len(done) <= geom["max_batch"]:
            fail(f"phase {phase} {label}: no slot was released and taken "
                 "again")
        runs[label] = (runner.generated, launched)
    same = runs["paged"][0] == runs["fixed-slot"][0]
    log(f"  paged tokens identical to fixed-slot tokens: {same} "
        f"({sum(len(v) for v in runs['paged'][0].values())} tokens)")
    if not same:
        fail(f"phase {phase}: paged tokens differ from fixed-slot tokens")
    del params
    torch.cuda.empty_cache()
    return runs["paged"][1]


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
# phase 8b: the ScaDLES trainer, the paper's own iteration


def scadles_source(n_devices):
    """The paper example's data (``examples/scadles_streaming.py``): 10
    class clusters of 192 training images, noise 0.8, seed 0, streamed IID
    to every device."""
    from repro_torch.data import ClassClusterData, DeviceDataSource
    data = ClassClusterData(num_classes=10, train_per_class=192, noise=0.8,
                            seed=0)
    return data, DeviceDataSource(data, n_devices, iid=True)


def scadles_arms():
    """The example's two arms: ScaDLES (rate-weighted batches, truncation,
    adaptive top-k) and conventional DDL (fixed batch 64, persistence)."""
    from repro_torch.core import PERSISTENCE, TRUNCATION
    n = SCADLES["n_devices"]
    return {"scadles": dict(n_devices=n, dist="S1", weighted=True,
                            policy=TRUNCATION, compression=(0.1, 0.3),
                            b_max=128, base_lr=0.05),
            "ddl": dict(n_devices=n, dist="S1", weighted=False,
                        policy=PERSISTENCE, b_max=128, base_lr=0.05)}


def scadles_pair(torch, make_src, rounds, eval_every=0, eval_fn=None,
                 curve=None, **cfg_kw):
    """The same trainer run on the card and on the CPU, from the same
    initial parameters (drawn on the CPU from the seed) and numpy seeds.
    Each run reads the data source ``make_src()`` gives it (a source may
    hold state that a run consumes: buffers, rng states, cursors), and
    ``curve()``, if given, makes its stream's rate curve; returns
    {device: (trainer, wall s)}."""
    from repro_torch.core import ScaDLESConfig, ScaDLESTrainer
    from repro_torch.models.mlp import make_mlp
    out = {}
    for dev in (DEVICE, "cpu"):
        tr = ScaDLESTrainer(make_mlp(), make_src(),
                            ScaDLESConfig(device=dev, **cfg_kw))
        if curve is not None:
            tr.sim.rate_curve = curve()
        t0 = time.perf_counter()
        tr.run(rounds, eval_every=eval_every, eval_fn=eval_fn)
        torch.cuda.synchronize()
        out[dev] = (tr, time.perf_counter() - t0)
    return out


def hold_scadles(torch, label, pair, phase="8b"):
    """Every host field of every round identical on the card and the CPU;
    loss (and the held-out eval loss, where a round has one) within
    SCADLES_TOL each round; final params within its bound.  Returns the
    worst loss error, the worst in each quarter of the run (how it grows
    round by round), the params' error and its bound."""
    (card, _), (cpu, _) = pair[DEVICE], pair["cpu"]
    if len(card.history) != len(cpu.history):
        fail(f"phase {phase} {label}: round counts differ")
    worst = worst_abs = 0.0
    quarters = [0.0] * 4
    for i, (c, h) in enumerate(zip(card.history, cpu.history)):
        if c.keys() != h.keys():
            fail(f"phase {phase} {label}: round {h['step']} fields differ")
        for key in h:
            if key not in ("loss", "gap", "eval_loss") and c[key] != h[key]:
                fail(f"phase {phase} {label}: round {h['step']} {key} on the "
                     f"card {c[key]!r} != CPU {h[key]!r}")
        for key in ("loss", "eval_loss"):
            if key not in h:
                continue
            err = abs(c[key] - h[key])
            if not (math.isfinite(c[key]) and err <= SCADLES_TOL["loss_rel"]
                    * abs(h[key]) + SCADLES_TOL["loss_abs"]):
                fail(f"phase {phase} {label}: round {h['step']} {key} "
                     f"{c[key]} on the card, {h[key]} on the CPU")
            if key == "loss":
                rel = err / max(abs(h[key]), 1e-30)
                worst, worst_abs = max(worst, rel), max(worst_abs, err)
                q = 4 * i // len(cpu.history)
                quarters[q] = max(quarters[q], err)
    d_param = max(max_err(card.params[k].cpu(), cpu.params[k])
                  for k in cpu.params)
    bound_p = SCADLES_TOL["param_abs"][card.compressor is not None]
    if not d_param <= bound_p:
        fail(f"phase {phase} {label}: params differ by {d_param:.3e} (bound "
             f"{bound_p:g})")
    growth = ", ".join(f"{e:.2e}" for e in quarters)
    return (f"{worst:.3e} rel, {worst_abs:.3e} abs (worst abs by quarter of "
            f"the run: {growth})"), d_param, bound_p


def scadles_accuracy(torch, model_predict, params, data):
    x = torch.from_numpy(data.test_x).to(params["w1"].device)
    pred = model_predict(params, x).argmax(-1).cpu().numpy()
    return float((pred == data.test_y).mean())


def scadles_path(torch, mods, card):
    """(a) the paper's two arms and (b) two relaxed fleet policies, each on
    the card against the CPU; no kernel may launch."""
    from repro_torch.fleet import FleetConfig
    from repro_torch.models.mlp import make_mlp
    rounds = SCADLES["rounds"]
    n = SCADLES["n_devices"]
    log(f"# phase 8b: the ScaDLES trainer, {n} devices, the edge MLP at full "
        f"width (197 322 f32 params), {rounds} rounds on the card against "
        "the CPU")
    data, src = scadles_source(n)
    predict = make_mlp()["predict"]
    reset(mods)
    arms = {}
    for label, kw in scadles_arms().items():
        pair = scadles_pair(torch, lambda: src, rounds, **kw)
        worst, d_param, bound_p = hold_scadles(torch, label, pair)
        tr, wall = pair[DEVICE]
        arms[label] = tr
        s = tr.summary()
        log(f"  {label}: sim time {s['sim_time_s']:.3f} s, buffer final "
            f"{s['buffer_final']:.0f}, peak {s['buffer_peak']:.0f}"
            + (f", cnc {s['cnc_ratio']:.3f}" if "cnc_ratio" in s else "")
            + f", final loss {tr.history[-1]['loss']:.6f}, test acc "
            f"{scadles_accuracy(torch, predict, tr.params, data):.4f} "
            f"(CPU {scadles_accuracy(torch, predict, pair['cpu'][0].params, data):.4f}); "
            f"card vs CPU: host fields identical in {rounds} rounds, loss "
            f"err <= {worst} (bound {SCADLES_TOL['loss_rel']:g} rel + "
            f"{SCADLES_TOL['loss_abs']:g} abs), params {d_param:.3e} "
            f"(bound {bound_p:g}); {wall:.2f} s wall on the card, "
            f"{pair['cpu'][1]:.2f} s on the CPU  [{card}]")
    sc, dd = arms["scadles"], arms["ddl"]
    log(f"  Table VI at this scale: sim-time speedup (DDL over ScaDLES) "
        f"{dd.sim_time_s / sc.sim_time_s:.3f}x; accuracy ScaDLES "
        f"{scadles_accuracy(torch, predict, sc.params, data):.4f}, DDL "
        f"{scadles_accuracy(torch, predict, dd.params, data):.4f}; buffer "
        f"reduction {dd.summary()['buffer_final'] / max(sc.summary()['buffer_final'], 1):.1f}x")
    log(f"  summaries: scadles {json.dumps(sc.summary())}; ddl "
        f"{json.dumps(dd.summary())}")
    for policy, knobs in (("async", {}), ("semi-sync", {"semi_sync_k": 4})):
        kw = dict(scadles_arms()["scadles"],
                  fleet=FleetConfig(profile="jetson-mixed", policy=policy,
                                    **knobs))
        pair = scadles_pair(torch, lambda: src, rounds, **kw)
        worst, d_param, bound_p = hold_scadles(torch, policy, pair)
        tr, wall = pair[DEVICE]
        s = tr.summary()
        if not (s["fleet_mean_staleness"] > 0 and s["fleet_version"] == rounds):
            fail(f"phase 8b {policy}: committed no stale gradient ({s})")
        log(f"  jetson-mixed {policy}{' k 4' if knobs else ''}: sim time "
            f"{s['sim_time_s']:.3f} s, version {s['fleet_version']:.0f}, "
            f"part rate {s['fleet_part_rate']:.3f}, mean staleness "
            f"{s['fleet_mean_staleness']:.3f} (max "
            f"{s['fleet_max_staleness']:.0f}), n_part/mean_stale/"
            f"model_version identical in every round; final loss "
            f"{tr.history[-1]['loss']:.6f}, test acc "
            f"{scadles_accuracy(torch, predict, tr.params, data):.4f}; loss "
            f"err <= {worst}, params {d_param:.3e} (bound "
            f"{bound_p:g}); {wall:.2f} s wall on the card, "
            f"{pair['cpu'][1]:.2f} s on the CPU  [{card}]")
    torch.cuda.synchronize()
    if counts(mods) != expect():
        fail(f"the trainer launched kernels: {counts(mods)}")
    log("  no kernel launched on the trainer's path (as the reference: "
        "exact top-k, inline momentum update)")


def time_scadles(torch, card):
    """(c) Rounds at the config's own defaults (16 devices, b_max 1024, S2,
    truncation, cr 0.1): wall ms (host clock around synchronised rounds),
    host time in buffers and the draw, CUDA-event splits of the rest, the
    device's busy share from torch.profiler, peak memory, MFU two ways;
    then the same for async rounds on jetson-mixed (the carry path)."""
    from repro_torch.core import TRUNCATION, ScaDLESConfig, ScaDLESTrainer
    from repro_torch.fleet import FleetConfig
    from repro_torch.models.mlp import make_mlp
    from repro_torch.obs import MemoryTracker
    n = SCADLES["n_devices"]
    log(f"# phase 8b: trainer round times on {card}")
    _, src = scadles_source(n)
    kw = dict(n_devices=n, dist="S2", weighted=True, policy=TRUNCATION,
              compression=(0.1, 0.3), b_max=1024, device=DEVICE)
    for label, fleet in (("lockstep", None),
                         ("jetson-mixed async (carry path)",
                          FleetConfig(profile="jetson-mixed",
                                      policy="async"))):
        mt = MemoryTracker()
        tr = ScaDLESTrainer(make_mlp(), src,
                            ScaDLESConfig(fleet=fleet, tracker=mt, **kw))
        time_rounds(torch, card, label, tr, mt, SCADLES["timed_rounds"])
        del tr
    torch.cuda.empty_cache()


def time_rounds(torch, card, label, tr, mt, timed, warm=2):
    """Time ``timed`` rounds of ``tr`` (after ``warm``) and print the
    split; ``mt`` is the trainer's MemoryTracker."""
    n, b_max = tr.cfg.n_devices, tr.cfg.b_max
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    tr.on_phase = mark
    walls, splits = [], []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        marks.clear()
        mark("start")
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if i < warm:
            continue
        walls.append(wall)
        at = {name: (ev, t) for name, ev, t in marks}
        if "grads" not in at:
            continue                 # an empty commit: no step ran
        sp = {"host (buffers, draw)": (at["host"][1] - at["start"][1])
              * 1e3}
        names = ["host", "upload", "grads", "compress", "aggregate",
                 "update"]
        for a, b in zip(names, names[1:]):
            sp[b] = at[a][0].elapsed_time(at[b][0])
        sp["rest (sync, host)"] = wall - sum(sp.values())
        splits.append(sp)
    tr.on_phase = None
    # the trainer's own peak: above what earlier phases still hold
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    med = sorted(walls)[len(walls) // 2]
    split = {k: sorted(s[k] for s in splits)[len(splits) // 2]
             for k in splits[0]}
    rounds = [r["data"] for r in mt.of_kind("train_round")
              if r["data"]["step_flops"]]
    flops = rounds[-1]["step_flops"]
    sim_mfu = sorted(r["mfu"] for r in rounds)[len(rounds) // 2]
    gb = float(sorted(r["global_batch"] for r in rounds)[len(rounds) // 2])
    log(f"  {label}: {med:.3f} ms wall a round (median of "
        f"{len(walls)}; all {', '.join(f'{w:.1f}' for w in walls)}); "
        "split (host clock for the host phase, CUDA events for the "
        "rest, medians of "
        f"{len(splits)} rounds that ran a step): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; batch tensor {n} x {b_max} x 3072 f32 = "
        f"{n * b_max * 3072 * 4 / 1e6:.1f} MB, global batch {gb:.0f}; "
        f"peak {peak:.1f} MiB allocated above the {held / 2**30:.2f} "
        f"GiB held before  [{card}]")
    log(f"  {label}: step flops {flops:.4g} (counted on meta copies); "
        f"MFU against the paper's K80 peak in sim time "
        f"{sim_mfu:.6f} (the reference's metric); on this card "
        f"{flops / (med / 1e3) / PEAK_OPS['float32']:.6f} of the f32 "
        f"67 TFLOP/s peak over the round's wall time  [{card}]")
    report_profile(profiled(torch, lambda: tr.run(1), 3),
                   f"{label} round", 3, med, card, top=6)


# ---------------------------------------------------------------------------
# phase 8c: the non-IID data plane through the trainer


def streamdata_data():
    """The non-IID sweep's data (``benchmarks/common.py::shared_data``):
    10 class clusters of 192 training and 32 test images, noise 0.8,
    seed 0."""
    from repro_torch.data import ClassClusterData
    return ClassClusterData(num_classes=10, train_per_class=192,
                            test_per_class=32, noise=0.8, seed=0)


def global_eval_fn(torch, model, data):
    """``benchmarks/common.py::global_eval_fn``: the held-out global test
    loss, on the device the params live on."""
    held = {}

    def eval_fn(params):
        dev = params["w1"].device
        if dev not in held:
            held[dev] = (torch.from_numpy(data.test_x).to(dev),
                         torch.from_numpy(data.test_y).to(dev))
        x, y = held[dev]
        return {"eval_loss": float(torch.mean(
            model["per_sample_loss"](params, x, y)))}

    return eval_fn


def streamdata_runs(data):
    """Phase 8c's runs: label -> (make_src, rounds, eval_every, curve,
    ScaDLESConfig kwargs).  Every source is built anew from seed 0 for
    each run and each device."""
    from repro_torch.core import PERSISTENCE, TRUNCATION
    from repro_torch.core.buffer import DROP_OLDEST
    from repro_torch.fleet import FleetConfig
    from repro_torch import streamdata as sd
    sdc = STREAMDATA
    n = sdc["n_devices"]

    def stream(alpha, **kw):
        return lambda: sd.make_stream_source(data, n, skew="dirichlet",
                                             alpha=alpha, seed=0, **kw)

    def diurnal():
        return sd.compose_curves(sd.DiurnalCurve(
            phase=np.linspace(0.0, 1.0, n, endpoint=False), **sdc["diurnal"]))

    arm = dict(n_devices=n, dist="S1", weighted=True, policy=TRUNCATION,
               compression=(0.1, 0.3), b_max=128, base_lr=0.05,
               skew_weighting=True)
    sweep = dict(n_devices=n, dist="S1", weighted=True, policy=TRUNCATION,
                 b_max=128, base_lr=0.15, grad_floats=60.2e6,
                 skew_weighting=True, noniid_damping=1.0)
    runs = {
        "(a) scadles, dirichlet a 0.1": (stream(0.1), sdc["rounds"], 0, None,
                                         arm),
        "(a) ddl, dirichlet a 0.1": (
            stream(0.1), sdc["rounds"], 0, None,
            dict(n_devices=n, dist="S1", weighted=False, policy=PERSISTENCE,
                 b_max=128, base_lr=0.05))}
    for policy, (rounds, every, knobs) in sdc["sweep"].items():
        runs[f"(b) jetson-mixed churn {policy}, dirichlet a 0.05"] = (
            stream(0.05), rounds, every, None,
            dict(sweep, fleet=FleetConfig(profile="jetson-mixed",
                                          policy=policy, churn=True,
                                          **knobs)))
    runs["(c) sharded loader, contiguous, drop-oldest, diurnal, S2"] = (
        lambda: sd.make_sharded_loader(
            data, n, shards_per_device=2, skewed=True,
            max_buffer=sdc["max_buffer"], evict=DROP_OLDEST, seed=0),
        sdc["rounds"], 0, diurnal,
        dict(arm, dist="S2", compression=None))
    runs["(c) rotating drift, dirichlet a 0.1, diurnal, S2"] = (
        stream(0.1, drift=sd.DriftSpec("rotate", **sdc["rotate"])),
        sdc["rounds"], 0, diurnal, dict(arm, dist="S2", compression=None))
    return runs


def streamdata_path(torch, mods, card):
    """Phase 8c: each run on the card against the CPU, at phase 8b's
    limits; the held-out eval loss within the loss limit; the loader's
    conservation on the card; no kernel may launch."""
    from repro_torch.models.mlp import make_mlp
    n = STREAMDATA["n_devices"]
    log(f"# phase 8c: the non-IID data plane through the trainer, {n} "
        "devices, the edge MLP at full width (197 322 f32 params), on the "
        "card against the CPU")
    data = streamdata_data()
    model = make_mlp()
    eval_fn = global_eval_fn(torch, model, data)
    reset(mods)
    for label, (make_src, rounds, every, curve, kw) in \
            streamdata_runs(data).items():
        pair = scadles_pair(torch, make_src, rounds, eval_every=every,
                            eval_fn=eval_fn if every else None, curve=curve,
                            **kw)
        worst, d_param, bound_p = hold_scadles(torch, label, pair, "8c")
        tr, wall = pair[DEVICE]
        cpu = pair["cpu"][0]
        s = tr.summary()
        if s != cpu.summary():
            fail(f"phase 8c {label}: summaries differ: {s} != "
                 f"{cpu.summary()}")
        if tr.fleet is not None and (tr.fleet.telemetry_summary()
                                     != cpu.fleet.telemetry_summary()):
            fail(f"phase 8c {label}: fleet telemetry differs")
        divs = [h["label_div_mean"] for h in tr.history]
        if not max(divs) > 0.1:
            fail(f"phase 8c {label}: no skew reached the trainer ({divs})")
        extra = ""
        if hasattr(tr.data, "conservation"):
            c = tr.data.conservation()
            if not (c["balanced"] and c == cpu.data.conservation()
                    and c["dropped"] > 0):
                fail(f"phase 8c {label}: loader accounting {c} (CPU "
                     f"{cpu.data.conservation()})")
            short = sum(h["global_batch"] for h in tr.history) - c["taken"]
            extra = (f"; loader streamed {c['streamed']}, taken "
                     f"{c['taken']}, dropped {c['dropped']}, buffered "
                     f"{c['buffered']} (balanced on the card and equal to "
                     f"the CPU's), {short:.0f} samples asked for and not "
                     "there (short batches)")
        if tr.fleet is not None:
            extra += (f"; commits {s['fleet_version']:.0f}, mean staleness "
                      f"{s['fleet_mean_staleness']:.3f}, fleet mean label "
                      f"divergence {tr.fleet.telemetry_summary()['mean_label_divergence']:.4f}")
        evals = [h for h in tr.history if "eval_loss" in h]
        if evals:
            hit = next((h["sim_time_s"] for h in evals
                        if h["eval_loss"] < STREAMDATA["eval_target"]), None)
            extra += (f"; eval loss {evals[-1]['eval_loss']:.5f} (CPU "
                      f"{[h for h in cpu.history if 'eval_loss' in h][-1]['eval_loss']:.5f}), "
                      f"time to eval loss {STREAMDATA['eval_target']:g}: "
                      + (f"{hit:.3f} s sim" if hit is not None
                         else f"not reached in {rounds} rounds"))
        log(f"  {label}: {rounds} rounds, sim time {s['sim_time_s']:.3f} s, "
            f"realised mean divergence {sum(divs) / len(divs):.4f} (max "
            f"{max(h['label_div_max'] for h in tr.history):.4f}), final "
            f"loss {tr.history[-1]['loss']:.6f}, test acc "
            f"{scadles_accuracy(torch, model['predict'], tr.params, data):.4f} "
            f"(CPU {scadles_accuracy(torch, model['predict'], cpu.params, data):.4f})"
            f"{extra}; card vs CPU: host fields identical in every round, "
            f"loss err <= {worst} (bound {SCADLES_TOL['loss_rel']:g} rel + "
            f"{SCADLES_TOL['loss_abs']:g} abs), params {d_param:.3e} "
            f"(bound {bound_p:g}); {wall:.2f} s wall on the card, "
            f"{pair['cpu'][1]:.2f} s on the CPU  [{card}]")
    torch.cuda.synchronize()
    if counts(mods) != expect():
        fail(f"the non-IID trainer runs launched kernels: {counts(mods)}")
    log("  no kernel launched on the non-IID trainer path")


def time_streamdata(torch, card):
    """Phase 8c timing: lockstep rounds at b_max 1024, S2 (phase 8b (c)'s
    setting) through a Dirichlet(0.1) stream and through the sharded
    loader, split as phase 8b's."""
    from repro_torch import streamdata as sd
    from repro_torch.core import TRUNCATION, ScaDLESConfig, ScaDLESTrainer
    from repro_torch.models.mlp import make_mlp
    from repro_torch.obs import MemoryTracker
    n = STREAMDATA["n_devices"]
    log(f"# phase 8c: non-IID trainer round times on {card}")
    data = streamdata_data()
    kw = dict(n_devices=n, dist="S2", weighted=True, policy=TRUNCATION,
              compression=(0.1, 0.3), b_max=1024, skew_weighting=True,
              device=DEVICE)
    for label, src in (
            ("lockstep, dirichlet a 0.1 stream",
             sd.make_stream_source(data, n, skew="dirichlet", alpha=0.1,
                                   seed=0)),
            ("lockstep, sharded loader (contiguous)",
             sd.make_sharded_loader(data, n, shards_per_device=2,
                                    skewed=True, seed=0))):
        mt = MemoryTracker()
        tr = ScaDLESTrainer(make_mlp(), src,
                            ScaDLESConfig(tracker=mt, **kw))
        time_rounds(torch, card, label, tr, mt, STREAMDATA["timed_rounds"])
        del tr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8d: the paper's CNN


def cnn_path(torch, mods, card):
    """Phase 8d: ``models/cnn.py`` at paper-cnn width on the card against
    the CPU (logits, loss, every gradient leaf), with cuDNN's TF32 allowed
    for the phase, so the model's own f32 convolutions are what is held;
    then forward + backward timed with CUDA events beside its counted
    flops.  No kernel of the port is on this path."""
    from repro_torch.configs import get_config
    from repro_torch.models import cnn_loss, cnn_forward, init_cnn
    from repro_torch.obs import counted_flops
    from repro_torch.tree import leaves, tree_map
    cfg = get_config("paper-cnn")
    b = CNN["batch"]
    log(f"# phase 8d: the paper CNN at full width ({cfg.num_layers} stages, "
        f"base {cfg.d_model}, d_ff {cfg.d_ff}), batch {b} x 32 x 32 x 3, on "
        "the card against the CPU")
    rng = np.random.default_rng(CNN["seed"])
    x = torch.from_numpy(rng.normal(size=(b, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32))
    params = init_cnn(torch.Generator().manual_seed(CNN["seed"]), cfg,
                      device="cpu")
    n_params = sum(t.numel() for t in leaves(params))

    def fwd_bwd(p, im, lab):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss = cnn_loss(live, im, lab, cfg)
        return loss, torch.autograd.grad(loss, leaves(live))

    def run(dev):
        p = tree_map(lambda t: t.to(dev), params)
        im, lab = x.to(dev), y.to(dev)
        with torch.no_grad():
            logits = cnn_forward(p, im, cfg)
        loss, grads = fwd_bwd(p, im, lab)
        return (p, im, lab, logits.cpu(), float(loss.detach()),
                [g.cpu() for g in grads])

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    reset(mods)
    try:
        p, im, lab, logits, loss, grads = run(DEVICE)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    if counts(mods) != expect():
        fail(f"the CNN launched kernels: {counts(mods)}")
    _, _, _, ref_logits, ref_loss, ref_grads = run("cpu")
    if not torch.isfinite(logits).all() or logits.shape != (b, cfg.vocab_size):
        fail(f"CNN logits {tuple(logits.shape)} not finite or misshapen")
    e_logit = max_err(logits, ref_logits) / float(ref_logits.abs().max())
    e_loss = abs(loss - ref_loss) / abs(ref_loss)
    e_grad = max(max_err(g, r) / max(float(r.abs().max()), 1e-30)
                 for g, r in zip(grads, ref_grads))
    log(f"  {n_params} f32 params; card vs CPU with cuDNN TF32 allowed: "
        f"logits {e_logit:.3e} of their max (bound {CNN['logit_rel']:g}), "
        f"loss {loss:.6f} vs {ref_loss:.6f}, {e_loss:.3e} rel (bound "
        f"{CNN['loss_rel']:g}), worst gradient leaf {e_grad:.3e} of its max "
        f"(bound {CNN['grad_rel']:g}); no kernel launched")
    if not (e_logit <= CNN["logit_rel"] and e_loss <= CNN["loss_rel"]
            and e_grad <= CNN["grad_rel"]):
        fail("the CNN on the card differs from the CPU")
    flops = counted_flops(fwd_bwd, p, im, lab)
    fwd_flops = counted_flops(lambda q, i: cnn_forward(q, i, cfg), p, im)
    ms = device_ms(torch, lambda: fwd_bwd(p, im, lab), iters=CNN["iters"])
    fwd_ms = device_ms(torch, lambda: cnn_forward(p, im, cfg),
                       iters=CNN["iters"])
    log(f"  forward + backward {ms:.4f} ms, forward {fwd_ms:.4f} ms (CUDA "
        f"events around {CNN['iters']} calls queued ahead of the card); "
        f"counted flops {flops:.4g} and {fwd_flops:.4g}: "
        f"{flops / (ms / 1e3) / 1e12:.2f} and "
        f"{fwd_flops / (fwd_ms / 1e3) / 1e12:.2f} TFLOP/s, "
        f"{flops / (ms / 1e3) / PEAK_OPS['float32']:.4f} and "
        f"{fwd_flops / (fwd_ms / 1e3) / PEAK_OPS['float32']:.4f} of the f32 "
        f"67 TFLOP/s peak  [{card}]")


# ---------------------------------------------------------------------------
# phase 8e: the training launcher


def train_step_path(torch, mods):
    """(a): ``make_train_step`` at full width and depth with momentum SGD:
    two steps on the kernel path, counted, against the same two on the
    plain path; then ``n_micro`` 2 against 1 and the bf16 wire, one step
    each.  Returns the kernel path's launch counts."""
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves
    log("# phase 8e (a): make_train_step, qwen2-0.5b full width and depth, "
        f"batch {TRAIN['batch']} x {TRAIN['seq']}, uniform sample weights, "
        f"momentum SGD {TRAIN['momentum']}, lr {TRAIN['lr']}")
    cfg, ctx, params, batch = train_setup(torch)
    b = TRAIN["batch"]
    batch["sample_weights"] = torch.full((b,), 1.0 / b, device=DEVICE)
    n_leaves = len(leaves(params))

    def run(backend, steps=1, **kw):
        """(params, state, metrics by step, synchronised wall ms by
        step)."""
        init, update = make_optimizer("sgdm", momentum=TRAIN["momentum"],
                                      backend=backend)
        step_fn = make_train_step(cfg, ctx, update, lambda i: TRAIN["lr"],
                                  **kw)
        p, s, ms, walls = params, init(params), [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = step_fn(p, s, batch, i)
            ms.append({k: float(v) for k, v in m.items()})
            walls.append((time.perf_counter() - t0) * 1e3)
        return p, s, ms, walls

    reset(mods)
    pk, _, mk, wk = run("kernel", steps=2)
    torch.cuda.synchronize()
    launched = counts(mods)
    want = expect(fused_sgdm=2 * n_leaves)
    log(f"  launches over two steps: {launched}; step walls "
        f"{', '.join(f'{w:.1f}' for w in wk)} ms (synchronised; the first "
        "warms up)")
    if launched != want:
        fail(f"make_train_step launched {launched}, expected {want}")
    pt, _, mt, _ = run("torch", steps=2)
    torch.cuda.synchronize()
    if counts(mods) != launched:
        fail(f"the plain optimizer launched kernels: {counts(mods)}")
    for i, (a, c) in enumerate(zip(mk, mt)):
        d_loss = abs(a["loss"] - c["loss"])
        log(f"  step {i}: loss {a['loss']:.6f} (plain {c['loss']:.6f}, diff "
            f"{d_loss:.3e}), grad_norm {a['grad_norm']:.6f} (plain "
            f"{c['grad_norm']:.6f})")
        if not math.isfinite(a["loss"]) or \
                d_loss > TRAIN_TOL["loss_rel"] * abs(c["loss"]):
            fail(f"step {i}: make_train_step's kernel path disagrees with "
                 "the plain path")
    d_param = max(max_err(x, y) for x, y in zip(leaves(pk), leaves(pt)))
    log(f"  after 2 steps: params max_abs_err {d_param:.3e} vs the plain "
        f"path (bound {TRAIN_TOL['param_abs']:g})")
    if not d_param <= TRAIN_TOL["param_abs"]:
        fail("make_train_step's params disagree with the plain path")
    del pk, pt

    whole, _, _, _ = run("kernel")
    micro, _, mm, wm = run("kernel", n_micro=2)
    worst = max(float(((x - y).abs() - MICRO_TOL["rtol"] * y.abs()).max())
                for x, y in zip(leaves(micro), leaves(whole)))
    log(f"  n_micro 2 against 1, one step ({wm[0]:.1f} ms): worst |diff| - "
        f"rtol * |whole| = {worst:.3e} (bound atol {MICRO_TOL['atol']:g}, "
        f"rtol {MICRO_TOL['rtol']:g})")
    if not worst <= MICRO_TOL["atol"]:
        fail("two microbatches disagree with the whole batch")
    del whole
    wire, _, mw, _ = run("kernel", n_micro=2, grad_wire_bf16=True)
    finite = all(bool(torch.isfinite(x).all()) for x in leaves(wire))
    moved = max(max_err(x, y) for x, y in zip(leaves(wire), leaves(micro)))
    log(f"  bf16 wire, n_micro 2: loss {mw[0]['loss']:.6f} (f32 wire "
        f"{mm[0]['loss']:.6f}), grad_norm {mw[0]['grad_norm']:.6f} (f32 wire "
        f"{mm[0]['grad_norm']:.6f}), params up to {moved:.3e} from the f32 "
        "wire's")
    if not (finite and math.isfinite(mw[0]["grad_norm"]) and moved > 0):
        fail("the bf16 wire run is not finite, or equals the f32 wire run")
    del wire, micro, params
    torch.cuda.empty_cache()
    return launched


def timing_steps(torch, make, step_ms):
    """``make_train_step`` wrapped so that each step's synchronised wall
    ms goes to ``step_ms``."""
    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed_step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed_step

    return timed_make


def launcher_path(torch, mods, card):
    """(b)-(d): the launcher at full width on the card, counted and timed;
    the card against the CPU from the same params; its checkpoint restored
    on the card and on the CPU.  Returns the launch counts of (b)."""
    import os
    import tempfile
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lt
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import leaves
    log(f"# phase 8e (b): python -m repro_torch.launch.train "
        f"{' '.join(LAUNCH_ARGV)} --ckpt <tmp> on {card}")
    lines, step_ms, save_s, update_ev = [], [], [], []

    def log_line(msg):
        log("  " + msg)
        lines.append(msg)

    make, save, make_opt = lt.make_train_step, lt.save_pytree, \
        lt.make_optimizer

    def timed_opt(*args, **kw):
        init, update = make_opt(*args, **kw)

        def timed_update(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = update(*a)
            ev[1].record()
            update_ev.append(ev)
            return out

        return init, timed_update

    timed_make = timing_steps(torch, make, step_ms)

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        save_s.append(time.perf_counter() - t0)
        return path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        lt.make_train_step, lt.save_pytree, lt.make_optimizer = \
            timed_make, timed_save, timed_opt
        try:
            reset(mods)
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params, _, hist = lt.train(
                lt.parse_args(LAUNCH_ARGV + ["--ckpt", tmp]), log=log_line)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            launched = counts(mods)
        finally:
            lt.make_train_step, lt.save_pytree, lt.make_optimizer = \
                make, save, make_opt
        cfg = get_config(lt.parse_args(LAUNCH_ARGV).arch)
        losses = [m["loss"] for m in hist]
        timed = sorted(step_ms[5:])
        upd = sorted(a.elapsed_time(b) for a, b in update_ev[5:])
        s_it = [ln for ln in lines if ln.startswith("step")][-1]
        log(f"  losses {losses[0]:.4f} -> {losses[-1]:.4f} over {len(hist)} "
            f"steps (ln V = {math.log(cfg.vocab_size):.4f}); printed "
            f"{s_it.split('(')[-1].rstrip(')')}; step "
            f"{timed[len(timed) // 2]:.3f} ms (median of steps 5-"
            f"{len(step_ms) - 1}, synchronised; all "
            f"{', '.join(f'{t:.1f}' for t in step_ms)}), of it Adam's update "
            f"{upd[len(upd) // 2]:.3f} ms (CUDA events, median); peak "
            f"{peak / 2**30:.2f} GiB allocated above the "
            f"{base / 2**30:.2f} GiB resident after a gc; launches "
            f"{launched}  [{card}]")
        if launched != expect():
            fail(f"the launcher (Adam) launched kernels: {launched}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]
                and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0):
            fail(f"the launcher's losses do not fall from ln V: {losses}")

        launcher_vs_cpu(torch, lt, cfg, card)

        log("# phase 8e (d): the launcher's checkpoint restored")
        name = cfg.name
        template = {"params": init_params(None, cfg, device="meta")}
        size = os.path.getsize(os.path.join(tmp, f"{name}.npz"))
        with open(os.path.join(tmp, f"{name}.paths.json")) as f:
            n_paths = len(json.load(f))
        t0 = time.perf_counter()
        back = restore_pytree(template, tmp, name=name, device=DEVICE)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        back_cpu = restore_pytree(template, tmp, name=name, device="cpu")
        t_cpu = time.perf_counter() - t0
        same = all(torch.equal(x, y) for x, y in
                   zip(leaves(back["params"]), leaves(params)))
        same_cpu = all(torch.equal(x, y.cpu()) for x, y in
                       zip(leaves(back_cpu["params"]), leaves(params)))
        log(f"  {size / 2**30:.3f} GiB npz, {n_paths} keys for "
            f"{len(leaves(params))} leaves; save {save_s[0]:.2f} s, restore "
            f"to the card {t_card:.2f} s, to the CPU {t_cpu:.2f} s; "
            f"bit-identical: card {same}, CPU {same_cpu}  [{card}]")
        if not (same and same_cpu and n_paths == len(leaves(params))):
            fail("the checkpoint did not restore bit for bit")
    del params, back, back_cpu
    torch.cuda.empty_cache()
    return launched


def launcher_vs_cpu(torch, lt, cfg, card):
    """(c): a short run of the same argv on the card and on the CPU from
    the same params (the card's init, copied to the CPU)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import leaves, tree_map
    argv = LAUNCH_ARGV + ["--steps", str(LAUNCH_CPU["steps"]), "--batch",
                          str(LAUNCH_CPU["batch"])]
    log(f"# phase 8e (c): {' '.join(argv)} on the card and with --device "
        "cpu, from the same params")
    gen = torch.Generator(device=DEVICE).manual_seed(
        lt.parse_args(argv).seed)
    start = init_params(gen, cfg, device=DEVICE)
    start_cpu = tree_map(lambda t: t.cpu(), start)

    def quiet(msg):
        pass

    p_card, _, h_card = lt.train(lt.parse_args(argv), params=start, log=quiet)
    del start
    t0 = time.perf_counter()
    p_cpu, _, h_cpu = lt.train(lt.parse_args(argv + ["--device", "cpu"]),
                               params=start_cpu, log=quiet)
    cpu_s = time.perf_counter() - t0
    for i, (a, c) in enumerate(zip(h_card, h_cpu)):
        rel = abs(a["loss"] - c["loss"]) / abs(c["loss"])
        log(f"  step {i}: loss {a['loss']:.6f} (CPU {c['loss']:.6f}, "
            f"{rel:.3e} rel), lr {a['lr']:.6e} (CPU {c['lr']:.6e})")
        if rel > LAUNCH_TOL["loss_rel"] or a["lr"] != c["lr"]:
            fail(f"step {i}: the launcher on the card parts from the CPU")
    lr_sum = sum(m["lr"] for m in h_cpu)
    d_max, n_flip, n = 0.0, 0, 0
    for x, y in zip(leaves(p_card), leaves(p_cpu)):
        d = (x - y.to(DEVICE)).abs()
        d_max = max(d_max, float(d.max()))
        n_flip += int((d > LAUNCH_TOL["param_flip"]).sum())
        n += d.numel()
    log(f"  after {len(h_cpu)} steps: params max |diff| {d_max:.3e} (bound "
        f"2 * sum(lr) = {2 * lr_sum:.3e}), {n_flip} of {n} elements "
        f"({n_flip / n:.3e}) beyond {LAUNCH_TOL['param_flip']:g} (bound "
        f"{LAUNCH_TOL['flip_share']:g}); the CPU run took {cpu_s:.1f} s  "
        f"[{card}]")
    if not (d_max <= 2 * lr_sum and n_flip / n < LAUNCH_TOL["flip_share"]):
        fail("the launcher's params on the card part from the CPU's")


# ---------------------------------------------------------------------------
# phases 8f-8i: the training attention, the launcher at 2 x 4 096, the mesh
# and context parallelism, the examples


def _grad_close(a, b, rtol, atol) -> float:
    """The worst |a - b| / (atol + rtol |b|) over a pair of gradients."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def _attention_inputs(torch, b, s, gen, device, grad=True):
    h, kvh, hd = (FLASH_TRAIN[k] for k in ("heads", "kv", "hd"))
    shapes = ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))
    return [torch.randn(shape, generator=gen, device=gen.device).to(
        device).requires_grad_(grad) for shape in shapes]


def _fwd_bwd(torch, attend, ts):
    o = attend(*ts)
    return o, torch.autograd.grad(torch.sin(o).sum(), ts)


def launches_in(torch, fn) -> int:
    """Kernel launches the host issued in one call of ``fn`` (the
    cudaLaunchKernel-style events under torch.profiler)."""
    events = profiled(torch, fn, 1)
    return sum(e.count for e in events if "LaunchKernel" in e.key)


def training_attention_path(torch, mods, card):
    """Phase 8f (a): the chunked flash (``chunked_attention(backend=
    "torch")``) forward and backward on the card against the CPU at
    qwen2-0.5b's head layout; then at 2 x 4 096 in turns with the full
    path (``flash_attention_ref`` under autograd): peak memory above the
    inputs, wall ms and launches of one forward + backward."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models.attention import chunked_attention
    ft = FLASH_TRAIN
    chunk = ft["chunk"]
    log(f"# phase 8f (a): the chunked flash on the card against the CPU, "
        f"f32, h {ft['heads']} kv {ft['kv']} hd {ft['hd']}, {ft['batch']} x "
        f"{ft['seq']}, chunks {chunk}")
    gen = torch.Generator().manual_seed(ft["seed"])
    for kind, window in ft["cases"]:
        base = _attention_inputs(torch, ft["batch"], ft["seq"], gen, "cpu",
                                 grad=False)

        def attend(q, k, v):
            return chunked_attention(q, k, v, kind=kind, window=window,
                                     chunk_q=chunk, chunk_k=chunk,
                                     backend="torch")

        reset(mods)
        card_o, card_g = _fwd_bwd(torch, attend, [
            x.to(DEVICE).requires_grad_() for x in base])
        torch.cuda.synchronize()
        launched = counts(mods)
        cpu_o, cpu_g = _fwd_bwd(torch, attend, [x.clone().requires_grad_()
                                                for x in base])
        err = max_err(card_o.detach().cpu(), cpu_o.detach())
        worst = max(_grad_close(a, b, ft["grad_rtol"], ft["grad_atol"])
                    for a, b in zip(card_g, cpu_g))
        log(f"  {kind} {window or ''}: forward max_abs_err {err:.3e} (bound "
            f"{ft['fwd_tol']:g}); gradients at {worst:.3f} of their bound "
            f"({ft['grad_rtol']:g} rel + {ft['grad_atol']:g}); launches "
            f"{launched}")
        if launched != expect():
            fail(f"phase 8f: the chunked flash launched kernels: {launched}")
        if not (err <= ft["fwd_tol"] and worst <= 1.0):
            fail(f"phase 8f {kind}: the card parts from the CPU")

    b, s = ft["batch"], ft["long_seq"]
    log(f"# phase 8f (a): one causal attention forward + backward at {b} x "
        f"{s}, chunks {chunk}: the chunked flash and the full path "
        "(flash_attention_ref under autograd), in turns")
    ts = _attention_inputs(torch, b, s, torch.Generator(
        device=DEVICE).manual_seed(ft["seed"]), DEVICE)
    paths = {
        "chunked": lambda q, k, v: chunked_attention(
            q, k, v, kind="causal", chunk_q=chunk, chunk_k=chunk,
            backend="torch"),
        "full": lambda q, k, v: flash_attention_ref(q, k, v, kind="causal")}
    (co, cg), (fo, fg) = (_fwd_bwd(torch, paths[n], ts)
                          for n in ("chunked", "full"))
    err = max_err(co.detach(), fo.detach())
    worst = max(_grad_close(a, b_, ft["grad_rtol"], ft["grad_atol"])
                for a, b_ in zip(cg, fg))
    del co, cg, fo, fg
    log(f"  chunked against full: forward max_abs_err {err:.3e}, gradients "
        f"at {worst:.3f} of their bound")
    if not (err <= ft["fwd_tol"] and worst <= 1.0):
        fail("phase 8f: the chunked flash parts from the full path")
    res = {n: {"ms": [], "peak": []} for n in paths}
    for name in ("chunked", "full", "full", "chunked"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = _fwd_bwd(torch, paths[name], ts)
        torch.cuda.synchronize()
        res[name]["ms"].append((time.perf_counter() - t0) * 1e3)
        res[name]["peak"].append(torch.cuda.max_memory_allocated() - base)
        del out
    for name in paths:
        res[name]["launches"] = launches_in(
            torch, lambda: _fwd_bwd(torch, paths[name], ts))
        r = res[name]
        log(f"  {name}: {', '.join(f'{t:.2f}' for t in r['ms'])} ms (wall, "
            f"synchronised, in turns), peak "
            f"{', '.join(f'{p / 2**30:.3f}' for p in r['peak'])} GiB above "
            f"the inputs, {r['launches']} launches (torch.profiler)  [{card}]")
    if max(res["chunked"]["peak"]) >= min(res["full"]["peak"]):
        fail("phase 8f: the chunked flash's peak memory is not below the "
             "full path's")
    del ts
    torch.cuda.empty_cache()


def long_launcher_path(torch, mods, card):
    """Phase 8g (b): the training launcher at full width and depth on
    2 x 4 096 tokens, through the chunked flash at chunk 128."""
    from repro_torch.launch import train as lt
    from repro_torch.optim.schedules import warmup_cosine
    log(f"# phase 8g (b): python -m repro_torch.launch.train "
        f"{' '.join(LONG_ARGV)} on {card}")
    args = lt.parse_args(LONG_ARGV)
    step_ms, lines = [], []
    make = lt.make_train_step

    def log_line(msg):
        log("  " + msg)
        lines.append(msg)

    lt.make_train_step = timing_steps(torch, make, step_ms)
    try:
        reset(mods)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, _, hist = lt.train(args, log=log_line)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launched = counts(mods)
    finally:
        lt.make_train_step = make
    schedule = warmup_cosine(args.lr, max(args.steps // 10, 1), args.steps)
    losses = [m["loss"] for m in hist]
    s_it = [ln for ln in lines if ln.startswith("step")][-1]
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; printed "
        f"{s_it.split('(')[-1].rstrip(')')}; steps "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ms (synchronised); peak "
        f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB resident "
        f"after a gc; launches {launched}  [{card}]")
    if launched != expect():
        fail(f"phase 8g: the launcher launched kernels: {launched}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 8g: a loss is not finite: {losses}")
    lrs = [m["lr"] for m in hist]
    if lrs != [schedule(i) for i in range(args.steps)]:
        fail(f"phase 8g: lr {lrs} is not the schedule's")
    del params, hist
    gc.collect()
    torch.cuda.empty_cache()


def mesh_path(torch, card):
    """Phase 8h (c): ``make_test_mesh`` on a one-rank NCCL group;
    ``context_parallel_attention`` over its (1, 1) mesh against
    ``chunked_attention(static_offset=False)`` bit for bit, forward and
    gradients; ``psum_weighted`` returns the gradient and the rate."""
    import torch.distributed as dist
    from repro_torch.core import psum_weighted
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.attention import (chunked_attention,
                                              context_parallel_attention)
    ft = FLASH_TRAIN
    chunk = ft["chunk"]
    log(f"# phase 8h (c): the mesh, context parallelism and psum_weighted on "
        f"a one-rank NCCL group, {ft['batch']} x {ft['seq']}")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        log(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
            f"{mesh.device_type} ({dist.get_backend()})")
        if (tuple(mesh.shape) != (1, 1) or mesh.device_type != "cuda"
                or mesh.mesh_dim_names != ("data", "model")):
            fail("phase 8h: make_test_mesh built the wrong mesh")
        gen = torch.Generator(device=DEVICE).manual_seed(ft["seed"] + 1)
        for kind, window in ft["cases"]:
            ts = _attention_inputs(torch, ft["batch"], ft["seq"], gen,
                                   DEVICE)
            cp = _fwd_bwd(torch, lambda q, k, v: context_parallel_attention(
                q, k, v, mesh, "model", kind=kind, window=window,
                chunk_q=chunk, chunk_k=chunk), ts)
            ref = _fwd_bwd(torch, lambda q, k, v: chunked_attention(
                q, k, v, kind=kind, window=window, q_offset=0,
                chunk_q=chunk, chunk_k=chunk, static_offset=False,
                backend="torch"), ts)
            same = [torch.equal(a, b) for a, b in
                    zip((cp[0], *cp[1]), (ref[0], *ref[1]))]
            log(f"  {kind} {window or ''}: output, dq, dk, dv bit-identical "
                f"to chunked_attention(static_offset=False): {same}")
            if not all(same):
                fail(f"phase 8h {kind}: context_parallel_attention differs")
        grad = {"a": torch.randn(4097, generator=gen, device=DEVICE),
                "b": {"c": torch.randn((7, 3), generator=gen,
                                       device=DEVICE)}}
        agg, total = psum_weighted(grad, 2.5, mesh, ("data", "model"))
        same = (torch.equal(agg["a"], grad["a"])
                and torch.equal(agg["b"]["c"], grad["b"]["c"]))
        log(f"  psum_weighted: the gradient back bit for bit {same}, total "
            f"rate {float(total)}")
        if not (same and float(total) == 2.5):
            fail("phase 8h: psum_weighted on one rank is not the identity")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8j: the sharded training step


def _whole(x):
    """A DTensor's global value (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _steps(torch, step_fn, params, state, batch, steps):
    """``steps`` steps from (params, state) -> (params, state, metrics as
    floats by step, synchronised wall ms by step)."""
    ms, walls = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        ms.append({k: float(_whole(v)) for k, v in m.items()})
    return params, state, ms, walls


def sharded_step_path(torch, mods, card):
    """Phase 8j: ``make_train_step`` on a (1, 1) mesh of a one-rank
    NCCL group against the unsharded step, counted, placed, timed in
    turns.  Returns the sharded n_micro 1 run's launch counts."""
    import torch.distributed as dist
    from repro_torch.dist import (batch_specs, distribute, make_plan,
                                  make_run_ctx, named, param_specs)
    from repro_torch.dist.sharding import placements_of
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves
    steps = SHARDED["steps"]
    log(f"# phase 8j: the sharded make_train_step, qwen2-0.5b full "
        f"width and depth, batch {TRAIN['batch']} x {TRAIN['seq']}, "
        "uniform sample weights, momentum SGD (fused_sgdm), a one-rank NCCL "
        "group's (1, 1) mesh")
    cfg, ctx, params, batch = train_setup(torch)
    b = TRAIN["batch"]
    batch["sample_weights"] = torch.full((b,), 1.0 / b, device=DEVICE)
    n_leaves = len(leaves(params))
    init, update = make_optimizer("sgdm", momentum=TRAIN["momentum"],
                                  backend="kernel")

    def lr(i):
        return TRAIN["lr"]

    launched = None
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        plan = make_plan(mesh)
        sctx = make_run_ctx(cfg, plan, compute_dtype=torch.float32,
                            param_dtype=torch.float32, remat=ctx.remat,
                            chunk_q=ctx.chunk_q, chunk_k=ctx.chunk_k,
                            loss_chunk=ctx.loss_chunk, device=DEVICE)
        specs = param_specs(params, cfg, plan)
        pd = distribute(params, specs, mesh)
        bd = distribute(batch, batch_specs(cfg, plan, batch), mesh)
        shard = named(params, specs, mesh)
        log(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
            f"{mesh.device_type} ({dist.get_backend()}); attn_mode "
            f"{sctx.attn_mode}")
        fns = {}
        for n_micro in (1, 2):
            fns[n_micro] = (
                make_train_step(cfg, ctx, update, lr, n_micro=n_micro),
                make_train_step(cfg, sctx, update, lr, n_micro=n_micro,
                                grad_shardings=shard))
            plain_fn, sharded_fn = fns[n_micro]
            pu, su, mu, _ = _steps(torch, plain_fn, params, init(params),
                                   batch, steps)
            reset(mods)
            ps, ss, msh, walls = _steps(torch, sharded_fn, pd, init(pd), bd,
                                        steps)
            got = counts(mods)
            want = expect(fused_sgdm=steps * n_leaves)
            if n_micro == 1:
                launched = got
            wrong = [i for i, (t, spec) in enumerate(zip(
                leaves(ps) + leaves(ss["mom"]), 2 * leaves(specs)))
                if not (hasattr(t, "placements") and tuple(t.placements)
                        == placements_of(mesh, spec))]
            d_p = max(max_err(_whole(x), y) for x, y in
                      zip(leaves(ps), leaves(pu)))
            d_m = max(max_err(_whole(x), y) for x, y in
                      zip(leaves(ss["mom"]), leaves(su["mom"])))
            same = all(torch.equal(_whole(x), y) for x, y in
                       zip(leaves(ps) + leaves(ss["mom"]),
                           leaves(pu) + leaves(su["mom"])))
            log(f"  n_micro {n_micro}: launches over {steps} sharded steps "
                f"{got}; step walls {', '.join(f'{w:.1f}' for w in walls)} "
                f"ms; {len(wrong)} of {2 * n_leaves} output leaves off "
                "their spec's placements")
            for i, (a, c) in enumerate(zip(msh, mu)):
                log(f"    step {i}: loss {a['loss']:.9g} (unsharded "
                    f"{c['loss']:.9g}, diff {abs(a['loss'] - c['loss']):.3e}"
                    f"), grad_norm {a['grad_norm']:.9g} (unsharded "
                    f"{c['grad_norm']:.9g}, diff "
                    f"{abs(a['grad_norm'] - c['grad_norm']):.3e})")
            log(f"    after {steps} steps: params max |diff| {d_p:.3e}, "
                f"momentum {d_m:.3e} (bound {TRAIN_TOL['param_abs']:g}); "
                f"bit-identical: {same}  [{card}]")
            if got != want:
                fail(f"phase 8j: the sharded step launched {got}, expected "
                     f"{want}")
            if wrong:
                fail(f"phase 8j: output leaves {wrong} lost their placements")
            if not (d_p <= TRAIN_TOL["param_abs"]
                    and d_m <= TRAIN_TOL["param_abs"]
                    and all(abs(a["loss"] - c["loss"])
                            <= TRAIN_TOL["loss_rel"] * abs(c["loss"])
                            and abs(a["grad_norm"] - c["grad_norm"])
                            <= TRAIN_TOL["loss_rel"] * abs(c["grad_norm"])
                            for a, c in zip(msh, mu))):
                fail(f"phase 8j: the sharded step at n_micro {n_micro} "
                     "parts from the unsharded one")
            del pu, su, ps, ss
        time_sharded_step(torch, fns[1], params, batch, pd, bd, init, card)
    finally:
        dist.destroy_process_group()
    del params, pd
    torch.cuda.empty_cache()
    return launched


def time_sharded_step(torch, fns, params, batch, pd, bd, init, card):
    """One untimed step of each side, then ``SHARDED["turn_steps"]`` steps
    without the mesh and on it, in turns (unsharded, sharded, sharded,
    unsharded), each synchronised, with its peak memory; the ratio is of
    the warm medians.  Then the launches a step of each under
    torch.profiler."""
    plain_fn, sharded_fn = fns
    runs = {"unsharded": (plain_fn, params, batch),
            "sharded": (sharded_fn, pd, bd)}
    for fn, p, bt_ in runs.values():
        _steps(torch, fn, p, init(p), bt_, 1)
    walls = {k: [] for k in runs}
    peaks = {k: [] for k in runs}
    for label in ("unsharded", "sharded", "sharded", "unsharded"):
        fn, p, bt_ = runs[label]
        state = init(p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, _, w = _steps(torch, fn, p, state, bt_, SHARDED["turn_steps"])
        walls[label] += w
        peaks[label].append(torch.cuda.max_memory_allocated() / 2**30)
        del state
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"  step wall in turns (unsharded, sharded, sharded, unsharded; "
        f"{SHARDED['turn_steps']} steps a turn after one untimed step "
        f"each): unsharded {', '.join(f'{w:.1f}' for w in walls['unsharded'])}"
        f" ms, sharded {', '.join(f'{w:.1f}' for w in walls['sharded'])} ms;"
        f" medians {med['unsharded']:.1f} / {med['sharded']:.1f} ms, ratio "
        f"{med['sharded'] / med['unsharded']:.3f}; peak "
        f"{max(peaks['unsharded']):.2f} / {max(peaks['sharded']):.2f} GiB "
        f"[{card}]")
    for label, (fn, p, bt_) in runs.items():
        state = init(p)
        n = launches_in(torch, lambda: fn(p, state, bt_, 0))
        log(f"  {label}: {n if n else 'not measured'} launches a step "
            "(torch.profiler)")
        del state


# phase 8k: the counting layer


def _count(hlo_cost, fn, *args):
    """(cost summary, recorded program) of one call of ``fn``."""
    program = hlo_cost.record(fn, *args)
    return hlo_cost.analyze(program), program


def counting_path(torch, mods, card):
    """Phase 8k: count phase 8e's step on the card's host, then time it
    against the count; calibrate and two dry runs in their own processes
    meanwhile.  Returns the timed steps' launch counts."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.dist import hlo_analysis, hlo_cost
    from repro_torch.dist.calibrate import calibrate
    from repro_torch.obs.mfu import lowered_flops
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, tree_map
    log(f"# phase 8k: the counting layer: qwen2-0.5b's make_train_step at "
        f"{TRAIN['batch']} x {TRAIN['seq']} (momentum SGD) counted and "
        "timed; calibrate and the dry runs on fake process groups")
    tmp = tempfile.mkdtemp(prefix="phase8k_")
    dry = {shape: _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "qwen2-0.5b", "--shape", shape, "--out",
                          tmp], ROOT) for shape in COUNT["dryruns"]}
    pool = ThreadPoolExecutor(max_workers=len(REF_CALIBRATION))
    cals = {key: pool.submit(calibrate, "qwen1.5-0.5b", *key,
                             cache_dir=str(Path(tmp) / "cal"),
                             repo_root=str(ROOT))
            for key in REF_CALIBRATION}
    try:
        launched = _count_and_time(torch, mods, card, hlo_analysis,
                                   hlo_cost, lowered_flops, make_optimizer,
                                   make_train_step, leaves, tree_map)
        for (n, cr), fut in cals.items():
            cal = fut.result(timeout=COUNT["timeout_s"])
            got = (cal.n_floats, cal.k, cal.dense_wire_bytes,
                   cal.compressed_wire_bytes)
            log(f"  (c) calibrate(qwen1.5-0.5b, n {n}, cr {cr}): n_floats "
                f"{got[0]}, k {got[1]}, dense {got[2]:.0f} and compressed "
                f"{got[3]:.0f} wire bytes (the reference's "
                f"{REF_CALIBRATION[(n, cr)]})")
            if got != REF_CALIBRATION[(n, cr)]:
                fail(f"phase 8k (c): calibrate at ({n}, {cr}) gave {got}")
        for shape, proc in dry.items():
            out = _finish(proc, f"the dry run of {shape}",
                          COUNT["timeout_s"], phase="8k (d)")
            ok = [line for line in out.splitlines() if line.startswith("OK")]
            path = Path(tmp) / f"qwen2-0.5b__{shape}__16x16.json"
            rec = json.loads(path.read_text())
            missing = [k for k in DRYRUN_KEYS if k not in rec]
            coll = rec["collective"]
            log(f"  (d) {ok[-1] if ok else out[-300:]}")
            log(f"      flops {rec['flops_per_chip']:.6g}, bytes "
                f"{rec['bytes_per_chip']:.6g}, wire {coll['total']:.6g} a "
                f"chip; collectives {int(coll['count'])}: "
                + ", ".join(f"{k} {coll[k]:.6g}" for k in
                            ("all-reduce", "all-gather", "reduce-scatter",
                             "all-to-all"))
                + f"; cpu_alltoall_as_allgather "
                f"{rec['cpu_alltoall_as_allgather']}; recorded in "
                f"{rec['record_s']:.1f} s")
            if missing or not ok or not rec["flops_per_chip"] > 0:
                fail(f"phase 8k (d): the {shape} artifact lacks {missing} "
                     f"or counts no flops")
            if shape.startswith("train") and not (
                    coll["all-gather"] > 0 and coll["reduce-scatter"] > 0):
                fail(f"phase 8k (d): the {shape} program on the 16 x 16 "
                     "mesh has no all-gather or no reduce-scatter")
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return launched


def _count_and_time(torch, mods, card, hlo_analysis, hlo_cost,
                    lowered_flops, make_optimizer, make_train_step, leaves,
                    tree_map):
    """(a) and (b) of phase 8k."""
    cfg, ctx, params, batch = train_setup(torch)
    b = TRAIN["batch"]
    batch["sample_weights"] = torch.full((b,), 1.0 / b, device=DEVICE)
    init, update = make_optimizer("sgdm", momentum=TRAIN["momentum"],
                                  backend="kernel")
    step_fn = make_train_step(cfg, ctx, update, lambda i: TRAIN["lr"])
    state = init(params)
    before = [t.clone() for t in leaves([params, batch])]
    torch.cuda.synchronize()
    reset(mods)
    allocated = torch.cuda.memory_allocated()
    got, program = _count(hlo_cost, step_fn, params, state, batch, 0)
    flops = lowered_flops(step_fn, params, state, batch, 0)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    same = all(torch.equal(x, y) for x, y in
               zip(before, leaves([params, batch])))
    del before
    cpu = tree_map(lambda t: t.cpu(), [params, state, batch])
    on_cpu, _ = _count(hlo_cost, step_fn, *cpu, 0)
    del cpu
    log(f"  (a) counted on the card's host: {got['flops']:.6g} flops, "
        f"{got['transcendentals']:.6g} transcendentals, {got['bytes']:.6g} "
        f"bytes, {len(program.ops)} ops, recorded in {program.seconds:.2f} s"
        f"; lowered_flops {flops}; unknown ops "
        f"{sorted(program.unknown) or 'none'}; the card's allocated bytes "
        f"{allocated} before, {after} after; launches {counts(mods)}; "
        f"params and batch unchanged: {same}; CPU copies' count equal: "
        f"{on_cpu == got}")
    if not (after == allocated and same and counts(mods) == expect()
            and on_cpu == got and flops == got["flops"]):
        fail("phase 8k (a): counting touched the card, or its count "
             "differs from the CPU copies' or from lowered_flops")
    _, _, _, walls = _steps(torch, step_fn, params, state, batch, 1)
    reset(mods)
    _, _, _, walls = _steps(torch, step_fn, params, state, batch,
                            COUNT["turn_steps"])
    launched = counts(mods)
    want = expect(fused_sgdm=COUNT["turn_steps"] * len(leaves(params)))
    if launched != want:
        fail(f"phase 8k (b): the timed steps launched {launched}, expected "
             f"{want}")
    med = statistics.median(walls) / 1e3
    compute_s = got["flops"] / PEAK_OPS["float32"]
    memory_s = got["bytes"] / HBM_BPS
    log(f"  (b) step walls {', '.join(f'{w:.1f}' for w in walls)} ms "
        f"(synchronised, after one untimed step), median {med * 1e3:.1f} ms:"
        f" {got['flops'] / med / 1e12:.2f} TFLOP/s counted, "
        f"{100 * compute_s / med:.1f}% of the f32 67 TFLOP/s peak "
        f"({compute_s * 1e3:.1f} ms); the counted bytes at 3.35 TB/s "
        f"{memory_s * 1e3:.1f} ms ({100 * memory_s / med:.1f}%); bound by "
        f"{'operations' if compute_s >= memory_s else 'bytes'}; the H100 "
        f"roofline (bf16 peak, as the dry run's) "
        f"{hlo_analysis.roofline(got['flops'], got['bytes'], 0.0)}; "
        f"launches {launched}  [{card}]")
    del params, state, batch
    torch.cuda.empty_cache()
    return launched


# phase 8l: sharded serving


def _greedy(torch, dec, place, params, prompts, cache, cfg, ctx, gen):
    """Prefill ``prompts`` into ``cache`` and take ``gen`` greedy steps;
    ``place(t)`` puts a token tensor where the params are.  -> (logits of
    the prefill and of each step as plain tensors, tokens (b, gen), prefill
    ms, decode ms by step): synchronised host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = dec.prefill_cache(params, place(prompts), cache, cfg,
                                      ctx)
    out = [_whole(logits)]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks, walls = [], []
    for _ in range(gen):
        tok = torch.argmax(out[-1], -1).to(torch.int32)[:, None]
        toks.append(tok)
        t0 = time.perf_counter()
        logits, cache = dec.decode_step(params, cache, place(tok), cfg, ctx)
        out.append(_whole(logits))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, torch.cat(toks, 1), prefill_ms, walls


def sharded_serving_path(torch, mods, serve, dec, res6, card):
    """Phase 8l (a) and (b): serving on a (1, 1) mesh of a one-rank NCCL
    group against the same run without a mesh, bit for bit; the lse
    output.  Then starts (c), the dry runs of the repaired classes, which
    :func:`finish_dry_classes` collects.  Returns (the sharded run's launch
    counts, the pending dry runs)."""
    import tempfile
    args = serve.parse_args(SERVE_ARGV)
    log(f"# phase 8l: sharded serving, qwen2-0.5b full width and depth, "
        f"{args.batch} x {args.prompt_len}, {args.gen} greedy steps, a "
        "one-rank NCCL group's (1, 1) mesh; the lse output; dry runs of the "
        "repaired classes")
    launched = _sharded_serving(torch, mods, serve, dec, res6, card, args)
    check_lse(torch, mods.fd)
    # started once (a) is timed, so its host clock does not share the CPU
    tmp = tempfile.mkdtemp(prefix="phase8l_")
    dry = {(cls, arch, shape): _start(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", tmp], ROOT)
        for cls, arch, shape in DRYRUN_CLASSES}
    return launched, (tmp, dry)


def finish_dry_classes(pending) -> None:
    """(c) of phase 8l: wait for the dry runs, each artifact complete with
    no unknown op; every process stopped and the directory removed
    whatever happens."""
    tmp, dry = pending
    try:
        for (cls, arch, shape), proc in dry.items():
            out = _finish(proc, f"the dry run of {arch} {shape}",
                          DRYRUN_TIMEOUT_S, phase="8l (c)")
            ok = [line for line in out.splitlines() if line.startswith("OK")]
            rec = json.loads((Path(tmp) / f"{arch}__{shape}__16x16.json"
                              ).read_text())
            missing = [k for k in DRYRUN_KEYS if k not in rec]
            coll = rec["collective"]
            log(f"  8l (c) class {cls}: {ok[-1] if ok else out[-300:]}")
            log(f"      flops {rec['flops_per_chip']:.6g}, bytes "
                f"{rec['bytes_per_chip']:.6g}, wire {coll['total']:.6g} a "
                f"chip; n_micro {rec['n_micro']}; unknown ops "
                f"{rec['unknown_ops'] or 'none'}; recorded in "
                f"{rec['record_s']:.1f} s")
            if (missing or not ok or not rec["flops_per_chip"] > 0
                    or rec["unknown_ops"]):
                fail(f"phase 8l (c): the {arch} {shape} artifact lacks "
                     f"{missing}, counts no flops or has unknown ops")
    finally:
        stop_dry_classes(pending)


def stop_dry_classes(pending) -> None:
    """Kill any dry run of phase 8l (c) still running; remove its
    directory."""
    import shutil
    tmp, dry = pending
    for proc in dry.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def _sharded_serving(torch, mods, serve, dec, res6, card, args):
    """(a) of phase 8l."""
    import torch.distributed as dist
    from repro_torch.dist import (batch_specs, cache_specs, distribute,
                                  make_plan, make_run_ctx, param_specs)
    from repro_torch.launch.mesh import make_test_mesh
    cfg, ctx, params, prompts, _ = serve.setup(args)
    if not torch.equal(prompts, res6["prompts"]):
        fail("phase 8l: prompts differ from phase 6's")
    b, gen, S = args.batch, args.gen, args.prompt_len + args.gen
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        plan = make_plan(mesh)
        sctx = make_run_ctx(cfg, plan, compute_dtype=torch.float32,
                            param_dtype=torch.float32, chunk_q=ctx.chunk_q,
                            chunk_k=ctx.chunk_k, device=DEVICE)
        pd = distribute(params, param_specs(params, cfg, plan), mesh)

        def place(t):
            return distribute({"t": t}, batch_specs(cfg, plan, {"t": t}),
                              mesh)["t"]

        def placed_cache():
            cache = dec.init_cache(cfg, b, S, sctx)
            return distribute(cache, cache_specs(cfg, plan, cache), mesh)

        runs = {"unsharded": lambda: _greedy(
                    torch, dec, lambda t: t, params, prompts,
                    dec.init_cache(cfg, b, S, ctx), cfg, ctx, gen),
                "sharded": lambda: _greedy(torch, dec, place, pd, prompts,
                                           placed_cache(), cfg, sctx, gen)}
        log(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
            f"{mesh.device_type} ({dist.get_backend()}); attn_mode "
            f"{sctx.attn_mode}")
        plain = runs["unsharded"]()
        reset(mods)
        sharded = runs["sharded"]()
        torch.cuda.synchronize()
        launched = counts(mods)
        want = expect(flash_attention=cfg.num_layers,
                      flash_decode=cfg.num_layers * gen)
        same = [torch.equal(x, y) for x, y in zip(sharded[0], plain[0])]
        worst = max(max_err(x, y) for x, y in zip(sharded[0], plain[0]))
        as6 = torch.equal(sharded[1].long(), res6["tokens"].long())
        log(f"  (a) launches on the sharded run {launched}; tokens equal to "
            f"the unsharded run's {torch.equal(sharded[1], plain[1])} and to "
            f"phase 6's {as6}; logits "
            f"bit-identical at {sum(same)} of {len(same)} points (prefill "
            f"and each step), largest |diff| {worst:.3e}")
        if launched != want:
            fail(f"phase 8l (a): the sharded run launched {launched}, "
                 f"expected {want}")
        if not (all(same) and torch.equal(sharded[1], plain[1]) and as6):
            fail(f"phase 8l (a): sharded serving parts from the unsharded "
                 f"run (largest logit |diff| {worst:.3e})")
        walls = {"unsharded": [], "sharded": []}
        prefills = {"unsharded": [], "sharded": []}
        for label in ("unsharded", "sharded", "sharded", "unsharded"):
            _, _, pre, w = runs[label]()
            prefills[label].append(pre)
            walls[label] += w[1:]            # the first step apart: warm-up
        med = {k: statistics.median(v) for k, v in walls.items()}
        log(f"  (a) in turns (unsharded, sharded, sharded, unsharded): "
            "prefill ms unsharded "
            + ", ".join(f"{t:.1f}" for t in prefills["unsharded"])
            + ", sharded "
            + ", ".join(f"{t:.1f}" for t in prefills["sharded"])
            + f"; decode ms a step (median of steps 2-{gen} of both turns) "
            f"unsharded {med['unsharded']:.2f}, sharded "
            f"{med['sharded']:.2f}, ratio "
            f"{med['sharded'] / med['unsharded']:.3f}  [{card}]")
    finally:
        dist.destroy_process_group()
    del params, pd
    torch.cuda.empty_cache()
    return launched


def check_lse(torch, fd):
    """(b) of phase 8l: the kernel's lse against the plain version's at
    LSE_CASES, f32 and bf16; o bit-identical with and without it."""
    gen = torch.Generator(device=DEVICE).manual_seed(95)
    for label, (b, S, h, kv, hd, lens) in LSE_CASES.items():
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v = (rand(torch, shape, dt, gen) for shape in
                       ((b, 1, h, hd), (b, S, kv, hd), (b, S, kv, hd)))
            kvl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            o = fd.flash_decode(q, k, v, kvl)
            o2, lse = fd.flash_decode(q, k, v, kvl, return_lse=True)
            _, ref = fd.flash_decode_ref(q, k, v, kvl, return_lse=True)
            err = max_err(lse, ref)
            same = torch.equal(o, o2)
            log(f"  (b) lse at {label} (b {b}, S {S}, h {h}, kv {kv}, hd "
                f"{hd}, kv_len {lens}), {dt_name}: max |lse - plain| "
                f"{err:.3e} (bound {TOL[dt_name]:g}); o bit-identical "
                f"without the flag: {same}")
            if not (err <= TOL[dt_name] and same):
                fail(f"phase 8l (b): lse at {label} {dt_name}")


# the example run in a fresh interpreter as __main__, then the wrappers'
# launch counts on a line of their own
_COUNTED_RUN = """
import json, runpy, sys
from repro_torch.kernels import block_topk as bt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import scatter_agg as sa
sys.argv = sys.argv[1:]
fa.launches = fd.launches = fd.paged_launches = sa.launches = 0
for key in bt.launches:
    bt.launches[key] = 0
runpy.run_path(sys.argv[0], run_name="__main__")
print("LAUNCHES " + json.dumps({
    "flash_attention": fa.launches, "flash_decode": fd.launches,
    "flash_decode_paged": fd.paged_launches,
    "block_topk": bt.launches["block_topk"],
    "fused_sgdm": bt.launches["fused_sgdm"],
    "scatter_aggregate": sa.launches}))
"""


def _example_cmd(name, args, counted=False):
    script = str(ROOT / "examples" / f"{name}_torch.py")
    if counted:
        return [sys.executable, "-c", _COUNTED_RUN, script, *args]
    return [sys.executable, script, *args]


def _start(cmd, cwd, threads=None):
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, label, timeout, phase="8i"):
    """Wait for ``proc``; fail with the tail of its errors unless it exits
    0.  Returns its standard output."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"phase {phase}: {label} ran past {timeout} s")
    if proc.returncode != 0:
        fail(f"phase {phase}: {label} exited {proc.returncode}: "
             f"{err[-3000:]}")
    return out


def _same_lines(card_out, cpu_out, loose_after, tol):
    """Card lines against the CPU's: the same text between the numbers,
    every number equal except those after a ``loose_after`` label (losses
    and accuracies), which may differ by ``tol``.  Returns the largest
    loose difference; fails on any other difference."""
    import re
    num = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    row = re.compile(r"^\s*\d+\s+\d+\.\d\s+")     # a fleet timeline row
    a_lines, b_lines = card_out.strip().splitlines(), \
        cpu_out.strip().splitlines()
    if len(a_lines) != len(b_lines):
        fail(f"phase 8i: {len(a_lines)} lines on the card, {len(b_lines)} "
             "on the CPU")
    worst = 0.0
    for a, b in zip(a_lines, b_lines):
        skel = num.split(b)
        if num.split(a) != skel:
            fail(f"phase 8i: card line {a!r} against CPU line {b!r}")
        for i, (x, y) in enumerate(zip(num.findall(a), num.findall(b))):
            if (skel[i].strip().endswith(loose_after)
                    or (row.match(b) and i == 2)):
                worst = max(worst, abs(float(x) - float(y)))
                if abs(float(x) - float(y)) > tol + 1e-9:
                    fail(f"phase 8i: card {a!r} against CPU {b!r}")
            elif x != y:
                fail(f"phase 8i: card line {a!r} against CPU line {b!r}")
    return worst


def examples_path(torch, mods, card):
    """Phase 8i (d): the five ``examples/*_torch.py`` on the card, each a
    fresh interpreter in a temporary working directory.  The CPU runs that
    two of them are held against run at the same time, on two threads
    each.  Returns ``serve_batched_torch.py``'s launch counts."""
    import os
    import tempfile
    ex = EXAMPLES
    log(f"# phase 8i (d): the five examples on {card}, python "
        "examples/<name>_torch.py, PYTHONPATH=src")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        def cwd(label):
            path = os.path.join(tmp, label.replace(" ", "_"))
            os.makedirs(path)
            return path

        held = {label: (name, args) for label, name, args in ex["card"]
                if label in ex["held"]}
        cpu_runs = {label: _start(_example_cmd(name, args + ["--device",
                                                             "cpu"]),
                                  cwd(label + " cpu"), threads=2)
                    for label, (name, args) in held.items()}
        try:
            outs, walls, launched = {}, {}, None
            for label, name, args in ex["card"]:
                counted = name == "serve_batched"
                t0 = time.perf_counter()
                out = _finish(_start(_example_cmd(name, args, counted),
                                     cwd(label)), label, ex["timeout_s"])
                walls[label] = time.perf_counter() - t0
                outs[label] = out
                tail = out.strip().splitlines()
                log(f"  {label}: {walls[label]:.1f} s wall (process start "
                    f"included); last line: {tail[-2 if counted else -1]}"
                    f"  [{card}]")
                if counted:
                    launched = json.loads(tail[-1].split(" ", 1)[1])
                    summary = dict(ln.split(" = ") for ln in tail[:-1])
                    n = int(summary["n_requests"])
                    done = int(summary["completed"]) + int(summary["dropped"])
                    log(f"  {label}: launches {launched}; {n} requests, "
                        f"{summary['completed']} completed, "
                        f"{summary['dropped']} dropped")
                    if not (launched["flash_attention"] > 0
                            and launched["flash_decode"] > 0
                            and launched == expect(
                                flash_attention=launched["flash_attention"],
                                flash_decode=launched["flash_decode"])):
                        fail(f"phase 8i: serve_batched launched {launched}")
                    if not (n > 0 and done == n):
                        fail(f"phase 8i: serve_batched lost requests: "
                             f"{summary}")
            cpu_outs = {label: _finish(proc, label + " --device cpu",
                                       ex["timeout_s"])
                        for label, proc in cpu_runs.items()}
        finally:
            for proc in cpu_runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        first, last = (float(x) for x in outs["quickstart"].strip()
                       .splitlines()[-1].split(":")[1].split("->"))
        if not last < first:
            fail(f"phase 8i: quickstart's loss did not fall ({first} -> "
                 f"{last})")
        for label, ckpt in ex["ckpt"].items():
            path = os.path.join(tmp, label.replace(" ", "_"), "artifacts",
                                "ckpt", ckpt)
            if not os.path.exists(path):
                fail(f"phase 8i: {label} wrote no checkpoint {ckpt}")
            s_it = [ln for ln in outs[label].splitlines()
                    if ln.startswith("step")][-1]
            log(f"  {label}: {s_it.split('(')[-1].rstrip(')')} printed, "
                f"{os.path.getsize(path) / 2**20:.1f} MiB checkpoint "
                f"{ckpt}  [{card}]")
        for label in held:
            worst = _same_lines(outs[label], cpu_outs[label],
                                ("acc=", "acc", "scadles=", "ddl=", "(drop",
                                 "loss=", "loss"), ex["acc_tol"])
            log(f"  {label}: every line equals the --device cpu run's, "
                f"losses and accuracies within {worst:.3g} (bound "
                f"{ex['acc_tol']:g})")
    return launched


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


def bound(n_bytes: float, n_ops: float, dtype_name: str, peak=None):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / (peak or PEAK_OPS[dtype_name]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(t, pre: str) -> str:
    """The kernel's time as a share of its bound, for the fields of a
    timing dict that start with ``pre``."""
    return f"{100 * t[pre + 'bound_ms'] / t[pre + 'ms']:.1f}%"


def time_fns(torch, kernel, plain, library):
    return {"ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, iters=5),
            "library_ms": device_ms(torch, library),
            "call_ms": call_ms(torch, kernel)}


def time_kernels(torch, fa, fd):
    """Kernel, plain and library device times at the serving path's shapes
    and at long ones: prefill attention (:func:`time_attention`) and
    decode (:func:`time_decode`)."""
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    return {"flash_attention": time_attention(torch, fa, gen),
            **time_decode(torch, fd, gen)}


def time_attention(torch, fa, gen):
    """``flash_attention`` at the offline prefill's shape (b 8, sq = sk =
    128) and at a long prompt (b 1, sq = sk = LONG_PROMPT), h 14, kv 2, hd
    64, causal, f32 and bf16: kernel, plain and SDPA device times beside
    the bound.  The f32 bound counts the unmasked pairs' operations at the
    3xTF32 rate (the kernel's f32 products run on the tensor cores);
    ``*cuda_core_bound_ms`` is the same work at the CUDA cores' 67 TFLOP/s,
    the bound of the kernel's earlier CUDA-core design.  Takes the kernel
    module as an argument, so a parent tree's module can be timed by the
    same code."""
    import torch.nn.functional as F
    h, kv, hd = 14, 2, 64
    out = {}
    for (b, s, pre) in ((8, 128, ""), (1, LONG_PROMPT, "long_")):
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q, k, v = (torch.randn((b, s, n, hd), generator=gen,
                                   device=DEVICE).to(dtype)
                       for n in (h, kv, kv))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            t = time_fns(
                torch, lambda: fa.flash_attention(q, k, v),
                lambda: fa.flash_attention_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            n_ops = 4 * hd * b * h * s * (s + 1) // 2   # unmasked pairs
            n_bytes = q.element_size() * (2 * q.numel() + k.numel()
                                          + v.numel())
            t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops, dt)
            if dt == "float32":
                t["cuda_core_bound_ms"] = t["bound_ms"]
                t["bound_ms"], t["bound_by"] = bound(
                    n_bytes, n_ops, dt, peak=TF32X3_OPS)
                if t["bound_by"] == "operations":
                    t["bound_by"] += ", 3xTF32"
            if pre:
                t.pop("call_ms")
                t["shape"] = (f"b {b}, sq = sk = {s}, h {h}, kv {kv}, hd "
                              f"{hd}, causal")
            key = pre + ("" if dt == "float32" else "bf16_")
            out.update({key + name: val for name, val in t.items()})
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return out


LONG_S = 16384          # phase 9's long context: K+V 134 MB at b 8, f32
LONG_PROMPT = 8192      # phase 9's long prompt (qwen2-0.5b's context: 32 768)


def time_decode(torch, fd, gen):
    """``flash_decode`` and ``flash_decode_paged`` at the serving shape (the
    offline run's last step, S 160; paged: pages of 16, 12 columns, 80
    rows) and at the long context (S = kv_len = LONG_S; paged: pages of 16,
    1024 columns, scrambled rows), b 8, h 14, kv 2, hd 64, f32: kernel,
    plain and library device times beside the bound.  The long shape's
    K+V is past the 50 MB L2, so its timing loop reads from HBM."""
    import torch.nn.functional as F
    b, h, kv, hd, pg = 8, 14, 2, 64, 16
    times = {"flash_decode": {}, "flash_decode_paged": {}}
    for S, pre in ((160, ""), (LONG_S, "long_")):
        kv_len = S
        qd = torch.randn((b, 1, h, hd), generator=gen, device=DEVICE)
        kc = torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
        vc = torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
        kvl = torch.full((b,), kv_len, dtype=torch.int32, device=DEVICE)
        qdt, kct, vct = (x.transpose(1, 2).contiguous()
                         for x in (qd, kc, vc))
        dec = time_fns(
            torch, lambda: fd.flash_decode(qd, kc, vc, kvl),
            lambda: fd.flash_decode_ref(qd, kc, vc, kvl),
            lambda: F.scaled_dot_product_attention(qdt, kct, vct,
                                                   enable_gqa=True))
        kv_bytes = 4 * 2 * b * kv_len * kv * hd
        dec["bound_ms"], dec["bound_by"] = bound(
            4 * 2 * qd.numel() + kv_bytes + 4 * b, 4 * hd * b * h * kv_len,
            "float32")
        if not pre:
            # the same launch writing its log-sum-exp beside o (phase 8l's
            # sharded decode), timed in the same call
            dec["lse_ms"] = device_ms(torch, lambda: fd.flash_decode(
                qd, kc, vc, kvl, return_lse=True))
            dec["lse_bound_ms"], dec["lse_bound_by"] = bound(
                4 * 2 * qd.numel() + kv_bytes + 4 * b + 4 * b * h,
                4 * hd * b * h * kv_len, "float32")
        del kc, vc, kct, vct

        ncols, rows = (12, 80) if pre == "" else (S // pg, b * S // pg)
        kp = torch.randn((rows, pg, kv, hd), generator=gen, device=DEVICE)
        vp = torch.randn((rows, pg, kv, hd), generator=gen, device=DEVICE)
        bt = block_table(torch, "scrambled", b, ncols, rows, gen)

        def gather_sdpa():             # two calls: pool[bt] gather + SDPA
            view = [pool[bt.long()].reshape(b, ncols * pg, kv, hd)[:, :kv_len]
                    .transpose(1, 2) for pool in (kp, vp)]
            return F.scaled_dot_product_attention(qdt, *view,
                                                  enable_gqa=True)

        paged = time_fns(
            torch, lambda: fd.flash_decode_paged(qd, kp, vp, bt, kvl),
            lambda: fd.flash_decode_paged_ref(qd, kp, vp, bt, kvl),
            gather_sdpa)
        paged["bound_ms"], paged["bound_by"] = bound(
            4 * 2 * qd.numel() + kv_bytes + 4 * b + 4 * bt.numel(),
            4 * hd * b * h * kv_len, "float32")
        del kp, vp, bt
        for name, t in (("flash_decode", dec), ("flash_decode_paged", paged)):
            if pre:
                t.pop("call_ms")
                t["shape"] = (f"b {b}, h {h}, kv {kv}, hd {hd}, S = kv_len "
                              f"= {S}, f32, K+V {kv_bytes / 1e6:.1f} MB")
            times[name].update({pre + key: val for key, val in t.items()})
        torch.cuda.empty_cache()
    return times


def swa_pairs(s: int, window: int) -> int:
    """Unmasked (query, key) pairs of an s x s causal window-``window``
    mask: query i sees min(i + 1, window) keys."""
    full = min(s, window)
    return full * (full + 1) // 2 + (s - full) * window


def time_zoo_kernels(torch, fa, fd, cfg, gen):
    """The attention kernels at recurrentgemma-2b's shapes (h 10, kv 1, hd
    256, f32, local window 2 048): ``flash_attention`` at phase 6b's prefill
    (b 8, s 128) and phase 6c's (b 1, s 2 112, past the window); both
    decode entries over a full 2 048-token ring at b 8 and b 1 (paged:
    pages of 16, scrambled rows).  Kernel, plain and library device times
    beside the bound, as :func:`time_attention` and :func:`time_decode`
    make them; the prefill bound counts the window's unmasked pairs."""
    import torch.nn.functional as F
    h, kv, hd, window = (cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim, cfg.window_size)
    out = {"flash_attention": {}, "flash_decode": {},
           "flash_decode_paged": {}}
    for b, s, pre in ((8, 128, "rg_"), (1, ZOO_RING["prompt"], "rg_long_")):
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=DEVICE)
                   for n in (h, kv, kv))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        i = torch.arange(s, device=DEVICE)
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        t = time_fns(
            torch, lambda: fa.flash_attention(q, k, v, kind="swa",
                                              window=window),
            lambda: fa.flash_attention_ref(q, k, v, kind="swa",
                                           window=window),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=band,
                                                   enable_gqa=True))
        t.pop("call_ms")
        n_ops = 4 * hd * b * h * swa_pairs(s, window)
        n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        t["cuda_core_bound_ms"], _ = bound(n_bytes, n_ops, "float32")
        t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops, "float32",
                                             peak=TF32X3_OPS)
        if t["bound_by"] == "operations":
            t["bound_by"] += ", 3xTF32"
        t["shape"] = (f"b {b}, sq = sk = {s}, h {h}, kv {kv}, hd {hd}, f32, "
                      f"swa window {window}")
        out["flash_attention"].update({pre + key: val
                                       for key, val in t.items()})
        del q, k, v, qt, kt, vt, band
    S, pg = window, 16
    for b, pre in ((8, "rg_"), (1, "rg_b1_")):
        qd = torch.randn((b, 1, h, hd), generator=gen, device=DEVICE)
        kc, vc = (torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
                  for _ in range(2))
        kvl = torch.full((b,), S, dtype=torch.int32, device=DEVICE)
        qdt, kct, vct = (x.transpose(1, 2).contiguous()
                         for x in (qd, kc, vc))
        kv_bytes = 4 * 2 * b * S * kv * hd
        n_ops = 4 * hd * b * h * S
        t = time_fns(torch, lambda: fd.flash_decode(qd, kc, vc, kvl),
                     lambda: fd.flash_decode_ref(qd, kc, vc, kvl),
                     lambda: F.scaled_dot_product_attention(
                         qdt, kct, vct, enable_gqa=True))
        t.pop("call_ms")
        t["bound_ms"], t["bound_by"] = bound(
            4 * 2 * qd.numel() + kv_bytes + 4 * b, n_ops, "float32")
        t["shape"] = (f"b {b}, h {h}, kv {kv}, hd {hd}, a full {S}-token "
                      f"ring, f32")
        out["flash_decode"].update({pre + key: val for key, val in t.items()})
        ncols, rows = S // pg, b * S // pg
        kp, vp = (torch.randn((rows, pg, kv, hd), generator=gen,
                              device=DEVICE) for _ in range(2))
        bt = block_table(torch, "scrambled", b, ncols, rows, gen)

        def gather_sdpa():
            view = [pool[bt.long()].reshape(b, S, kv, hd).transpose(1, 2)
                    for pool in (kp, vp)]
            return F.scaled_dot_product_attention(qdt, *view,
                                                  enable_gqa=True)

        t = time_fns(torch,
                     lambda: fd.flash_decode_paged(qd, kp, vp, bt, kvl),
                     lambda: fd.flash_decode_paged_ref(qd, kp, vp, bt, kvl),
                     gather_sdpa)
        t.pop("call_ms")
        t["bound_ms"], t["bound_by"] = bound(
            4 * 2 * qd.numel() + kv_bytes + 4 * b + 4 * bt.numel(), n_ops,
            "float32")
        t["shape"] = (f"b {b}, h {h}, kv {kv}, hd {hd}, a full {S}-token "
                      f"ring in pages of {pg}, f32")
        out["flash_decode_paged"].update({pre + key: val
                                          for key, val in t.items()})
        del qd, kc, vc, qdt, kct, vct, kp, vp, bt
    torch.cuda.empty_cache()
    return out


def time_zoo_serving(torch, serve, dec, get_config, card, archs=tuple(ZOO)):
    """Prefill (b 8, prompt 128) and decode steps (16, greedy) of each zoo
    model of ``archs``, host clock around synchronised work, with the
    decode step's device time and torch.profiler's breakdown; whisper's
    ``prefill_cross_kv`` (the encoder over 1 536 frames) timed on its own,
    before the prefill, as ``run_offline`` runs it; for mixtral also one
    MoE FFN at the decode shape, whose capacity of 320 rows an expert (from
    group_size 1024, whatever the call's length) sets its work."""
    from repro_torch.models import moe
    for arch in archs:
        log(f"# phase 9: {arch} serving times on {card}")
        cfg = zoo_cfg(get_config, arch)
        args = serve.parse_args(zoo_argv(arch, **ZOO_OFFLINE))
        cfg, ctx, params, prompts, _ = serve.setup(args, cfg)
        cache_len = args.prompt_len + args.gen
        feats = (serve.audio_feats(args, cfg, prompts.device)
                 if cfg.encoder_layers else None)
        prefill_ms, encode_ms = [], []
        for _ in range(3):
            cache = dec.init_cache(cfg, args.batch, cache_len, ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if feats is not None:
                cache = dec.prefill_cross_kv(params, feats, cfg, ctx, cache)
                torch.cuda.synchronize()
                encode_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
            logits, cache = dec.prefill_cache(params, prompts, cache, cfg,
                                              ctx)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(args.gen):
            nxt = torch.argmax(logits, -1)[:, None]
            logits, cache = dec.decode_step(params, cache, nxt, cfg, ctx)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / args.gen * 1e3
        enc = (f"prefill_cross_kv (b {args.batch}, {cfg.encoder_seq_len} "
               f"frames, {cfg.encoder_layers} encoder layers): "
               f"{sorted(encode_ms[1:])[0]:.3f} ms (warm runs "
               f"{', '.join(f'{t:.3f}' for t in encode_ms[1:])}); "
               if feats is not None else "")
        log(f"  {enc}prefill (b {args.batch}, prompt {args.prompt_len}): "
            f"{sorted(prefill_ms[1:])[0]:.3f} ms (warm runs "
            f"{', '.join(f'{t:.3f}' for t in prefill_ms[1:])}); decode "
            f"{step_ms:.3f} ms/step over {args.gen} steps  [{card}]")
        profile_decode(torch, dec, params, prompts, cfg, ctx, cache_len,
                       card, step_ms, steps=2, feats=feats)
        if cfg.moe is not None:
            bp = {k: v[0] for k, v in params["unit"]["p0"]["moe"].items()}
            x = torch.randn((args.batch, 1, cfg.d_model), device=DEVICE)
            ms = device_ms(torch, lambda: moe.moe_ffn(bp, x, cfg), iters=3)
            # a decode call's group is its one token: one row an expert
            E, C = cfg.moe.num_experts, min(moe.capacity(cfg.moe), 1)
            flops = 3 * 2 * args.batch * E * C * cfg.d_model * cfg.d_ff
            log(f"  one MoE FFN at the decode shape (b {args.batch}, s 1; E "
                f"{E}, C {C}): {ms:.3f} ms device, {flops:.3e} expert "
                f"flops ({flops / ms / 1e9:.1f} TFLOP/s) for "
                f"{args.batch * cfg.moe.top_k} routed token-experts  [{card}]")
        del params, cache, logits, feats
        torch.cuda.empty_cache()


def time_whisper_kernels(torch, fa, fd, cfg, gen):
    """The attention kernels at whisper-base's shapes (h 8, kv 8, hd 64,
    f32, 1 536 encoder frames): ``flash_attention`` bidir over the
    encoder's 8 x 1 536 x 1 536 and the decoder's cross-attention of a
    128-token prompt (8 x 128 queries over the 1 536 frames);
    ``flash_decode`` of the cross-attention, S = kv_len = 1 536, at b 8 and
    b 1.  Kernel, plain and SDPA device times beside the bound, as
    :func:`time_attention` and :func:`time_decode` make them (the prefill
    bound at the 3xTF32 rate, every pair unmasked)."""
    import torch.nn.functional as F
    h, kv, hd, S = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.encoder_seq_len)
    out = {"flash_attention": {}, "flash_decode": {}}
    for b, sq, pre, what in ((8, S, "wh_enc_", "the encoder"),
                             (8, 128, "wh_cross_", "a prompt's cross-"
                              "attention")):
        q = torch.randn((b, sq, h, hd), generator=gen, device=DEVICE)
        k, v = (torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        t = time_fns(
            torch, lambda: fa.flash_attention(q, k, v, kind="bidir"),
            lambda: fa.flash_attention_ref(q, k, v, kind="bidir"),
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        t.pop("call_ms")
        n_ops = 4 * hd * b * h * sq * S
        n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        t["cuda_core_bound_ms"], _ = bound(n_bytes, n_ops, "float32")
        t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops, "float32",
                                             peak=TF32X3_OPS)
        if t["bound_by"] == "operations":
            t["bound_by"] += ", 3xTF32"
        t["shape"] = (f"b {b}, sq {sq} over sk {S}, h {h}, kv {kv}, hd {hd}, "
                      f"f32, bidir ({what})")
        out["flash_attention"].update({pre + key: val
                                       for key, val in t.items()})
        del q, k, v, qt, kt, vt
    for b, pre in ((8, "wh_"), (1, "wh_b1_")):
        qd = torch.randn((b, 1, h, hd), generator=gen, device=DEVICE)
        kc, vc = (torch.randn((b, S, kv, hd), generator=gen, device=DEVICE)
                  for _ in range(2))
        kvl = torch.full((b,), S, dtype=torch.int32, device=DEVICE)
        qdt, kct, vct = (x.transpose(1, 2).contiguous()
                         for x in (qd, kc, vc))
        t = time_fns(torch, lambda: fd.flash_decode(qd, kc, vc, kvl),
                     lambda: fd.flash_decode_ref(qd, kc, vc, kvl),
                     lambda: F.scaled_dot_product_attention(qdt, kct, vct))
        t.pop("call_ms")
        t["bound_ms"], t["bound_by"] = bound(
            4 * 2 * qd.numel() + 4 * 2 * b * S * kv * hd + 4 * b,
            4 * hd * b * h * S, "float32")
        t["shape"] = (f"b {b}, h {h}, kv {kv}, hd {hd}, S = kv_len = {S} "
                      "(the cross-attention), f32")
        out["flash_decode"].update({pre + key: val for key, val in t.items()})
        del qd, kc, vc, qdt, kct, vct
    torch.cuda.empty_cache()
    return out


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
                   step_ms, steps=4, top=8, feats=None):
    """Where a decode step's time goes: its device time (CUDA events, the
    step queued ahead of the card) against ``step_ms`` of wall time, then
    torch.profiler's device time by kernel, where it records the card, and
    host time by op.  ``feats``: whisper's frames, for the cross K/V."""
    cache = dec.init_cache(cfg, prompts.shape[0], cache_len, ctx)
    if feats is not None:
        cache = dec.prefill_cross_kv(params, feats, cfg, ctx, cache)
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
    host = [e for e in events if not _on_device(e)]
    launch_ops = [e for e in host if "LaunchKernel" in e.key]
    log(f"  {label}: {sum(e.count for e in launch_ops) / steps:.0f} kernel "
        "launches a step (the host's "
        f"{', '.join(sorted({e.key for e in launch_ops})) or 'none seen'}"
        " calls under torch.profiler)")
    log("  host time by op (self, under torch.profiler):")
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

    build(_build, fa)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n_train = sum(p.numel() for p in leaves(init_params(
        None, get_config(TRAIN["arch"]), device="meta")))
    errs = check_kernels(torch, fa, fd)
    errs.update(check_train_kernels(torch, bt, sa, n_train))
    launched, res6 = serve_offline(torch, mods, serve, dec)
    paths = {f"6 {name}": n for name, n in
             serve_zoo(torch, mods, serve, dec, get_config).items()}
    paths.update(serve_zoo_rest(torch, mods, serve, dec, get_config))
    serve_slots(torch, mods, serve, dec)
    serve_paged(torch, mods, serve, dec, paging)
    sched_launched = serve_scheduled(torch, mods, serve, rt)
    serve_streaming(torch, mods, serve, rt)
    paths["7e recurrentgemma-2b paged"] = serve_zoo_paged(
        torch, mods, serve, rt, dec, get_config, "recurrentgemma-2b", "7e",
        ("paged",))
    paths["7f xlstm-125m paged"] = serve_zoo_paged(
        torch, mods, serve, rt, dec, get_config, "xlstm-125m", "7f",
        ("fixed", "paged direct"))
    launched["flash_decode_paged"] = sched_launched["flash_decode_paged"]
    train_launched, train = train_path(torch, mods)
    scadles_path(torch, mods, card)
    time_scadles(torch, card)
    streamdata_path(torch, mods, card)
    time_streamdata(torch, card)
    cnn_path(torch, mods, card)
    launched.update({name: train_launched[name] for name in
                     ("block_topk", "fused_sgdm", "scatter_aggregate")})
    times = time_train_kernels(torch, mods, train)
    time_training(torch, train, card)
    del train
    torch.cuda.empty_cache()
    paths["8e make_train_step"] = train_step_path(torch, mods)
    paths["8e launcher"] = launcher_path(torch, mods, card)
    training_attention_path(torch, mods, card)
    long_launcher_path(torch, mods, card)
    mesh_path(torch, card)
    paths["8j sharded make_train_step"] = sharded_step_path(torch, mods,
                                                            card)
    paths["8k counted make_train_step"] = counting_path(torch, mods, card)
    paths["8l sharded serving"], pending = sharded_serving_path(
        torch, mods, serve, dec, res6, card)
    del res6
    try:
        # 8l (c)'s dry runs run on the host while the examples run
        paths["8i serve_batched_torch.py"] = examples_path(torch, mods, card)
        finish_dry_classes(pending)
    finally:
        stop_dry_classes(pending)
    times.update(time_kernels(torch, fa, fd))
    zoo_times = time_zoo_kernels(
        torch, fa, fd, zoo_cfg(get_config, "recurrentgemma-2b"),
        torch.Generator(device=DEVICE).manual_seed(98))
    for name, t in zoo_times.items():
        times[name].update(t)
    wh_times = time_whisper_kernels(
        torch, fa, fd, zoo_cfg(get_config, "whisper-base"),
        torch.Generator(device=DEVICE).manual_seed(97))
    for name, t in wh_times.items():
        times[name].update(t)
    time_serving(torch, serve, dec, card)
    time_paged_steps(torch, serve, dec, rt, card)
    time_zoo_serving(torch, serve, dec, get_config, card)
    time_zoo_serving(torch, serve, dec, get_config, card, ZOO_REST)

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
        if "lse_ms" in t:
            log(f"  {name} with return_lse at the serving shape: device "
                f"{t['lse_ms']:.4f} ms (o alone {t['ms']:.4f} ms), bound "
                f"{t['lse_bound_ms']:.5f} ms ({t['lse_bound_by']})  [{card}]")
        if "long_ms" in t:
            log(f"  {name} at {t['long_shape']}: device {t['long_ms']:.4f} "
                f"ms, plain {t['long_plain_ms']:.4f} ms, library "
                f"{t['long_library_ms']:.4f} ms, bound "
                f"{t['long_bound_ms']:.5f} ms ({t['long_bound_by']}), "
                f"{100 * t['long_bound_ms'] / t['long_ms']:.1f}% of it  "
                f"[{card}]")
        if "cuda_core_bound_ms" in t:
            log(f"  {name} f32 share of its bound: {share(t, '')} "
                f"(the 67 TFLOP/s CUDA-core bound: "
                f"{100 * t['cuda_core_bound_ms'] / t['ms']:.1f}%); long "
                f"{share(t, 'long_')} (CUDA-core bound "
                f"{100 * t['long_cuda_core_bound_ms'] / t['long_ms']:.1f}%)"
                f"  [{card}]")
        for pre in ("rg_", "rg_long_", "rg_b1_", "wh_enc_", "wh_cross_",
                    "wh_", "wh_b1_"):
            if pre + "ms" in t:
                cc = t.get(pre + "cuda_core_bound_ms")
                core = (f" (CUDA-core bound {100 * cc / t[pre + 'ms']:.1f}%)"
                        if cc else "")
                log(f"  {name} at {t[pre + 'shape']}: device "
                    f"{t[pre + 'ms']:.4f} ms, plain {t[pre + 'plain_ms']:.4f}"
                    f" ms, library {t[pre + 'library_ms']:.4f} ms, bound "
                    f"{t[pre + 'bound_ms']:.5f} ms ({t[pre + 'bound_by']}), "
                    f"{share(t, pre)} of it{core}  [{card}]")
        for pre in ("bf16_", "long_bf16_"):
            if pre + "ms" in t:
                log(f"  {name} bf16{' long' if 'long' in pre else ''}: "
                    f"device {t[pre + 'ms']:.4f} ms, plain "
                    f"{t[pre + 'plain_ms']:.4f} ms, library "
                    f"{t[pre + 'library_ms']:.4f} ms, bound "
                    f"{t[pre + 'bound_ms']:.5f} ms ({t[pre + 'bound_by']}),"
                    f" {share(t, pre)} of it  [{card}]")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launched[name],
                        "max_abs_err": errs[name], **t,
                        "path_launches": {path: n[name]
                                          for path, n in paths.items()}})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

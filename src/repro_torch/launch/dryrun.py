"""Multi-pod dry run: record every (arch x input shape x mesh) step as the
aten program one rank executes and extract roofline inputs — no tensor is
ever allocated and no device is used.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape train_4k [--multi-pod] [--out artifacts/dryrun]

Counterpart of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles the step for 256 or 512 host devices, the port joins a fake
process group of that many ranks (``dist/hlo_cost.py::init_fake_world``;
no collective sends anything), builds the production mesh on the CPU, places
bf16 params, optimizer state and inputs as DTensors of fake CPU shards
(``dist/sharding.py::distribute``) and records one call of the step
(``dist/hlo_cost.py::record``).  The count is rank 0's: per chip, as the
reference's.

Writes one JSON artifact per combination, with the reference's keys and
these changes:

* ``flop_counter_raw`` in place of ``xla_flops_raw``: the total of
  ``torch.utils.flop_counter.FlopCounterMode`` over the same call, the
  framework's own count (matrix products only, DTensor-level ops at their
  global shapes);
* ``xla_bytes_raw`` is dropped: nothing but the recorder counts bytes;
* ``memory`` holds ``argument_bytes`` and ``output_bytes`` (rank 0's local
  shards) and ``peak_bytes_est``, the most bytes of fake storage alive at
  once during the recording (arguments included).  The reference's
  ``peak_bytes_tpu_adj`` corrects for the CPU backend's double-buffered
  scan of the decode cache, which the port does not have: its decode
  writes the cache in place;
* ``cpu_alltoall_as_allgather``: shard-to-shard redistributions that the
  CPU mesh ran as an all-gather and a chunk (an all-to-all on a CUDA
  mesh), so the all-gather bytes over-count them ``D``-fold;
* ``unknown_ops``: ops no counting rule names (charged bytes only).

``collective`` keeps ``total_looped`` beside ``total``: eager execution
counts every executed collective, so the two are equal.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.dist import hlo_analysis, hlo_cost
from repro_torch.dist.sharding import (attn_mode_for, batch_specs,
                                       cache_specs, distribute, make_plan,
                                       make_run_ctx, named, param_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import decode_inputs, train_batch_specs
from repro_torch.models.decode import decode_step
from repro_torch.models.transformer import (forward_hidden, init_params,
                                            logits_fn)
from repro_torch.optim.optimizers import sgdm_init, sgdm_update
from repro_torch.train.step import EXTRA_INPUTS, make_train_step


def pick_n_micro(cfg: ModelConfig, shape: InputShape, plan,
                 act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor so remat activation carries fit HBM.

    Per-chip live carry = L * (B/dp) * s * d * 2 / tp bytes (bf16 x per
    layer; the inter-block residual stack is sequence-sharded over TP —
    DESIGN.md §5).  Every extra microbatch re-gathers FSDP weights and
    reduce-scatters grads once more, so n_micro is the memory/collective
    trade-off knob: pick the smallest value that fits.
    """
    if shape.kind != "train":
        return 1
    dp = plan.dp_size
    b_local = max(shape.global_batch // dp, 1)
    seq_shard = plan.tp_size if shape.seq_len % plan.tp_size == 0 else 1
    carry = (cfg.num_layers * b_local * shape.seq_len * cfg.d_model * 2.0
             / seq_shard)
    # fp32 stacks can appear next to the bf16 ones (XLA hoists the bwd
    # upcast across the residual stack), so budget for 3x; MoE adds
    # dispatched-copy transients ~ tokens*topk*cf*d per layer backward;
    # hybrid/context archs add CP all-gathered KV + fp32 scan transients
    if cfg.moe is not None:
        carry *= 6.0       # dispatched-copy transients
    elif cfg.family in ("hybrid", "ssm"):
        carry *= 8.0       # CP-gathered KV + fp32 recurrent-scan transients
    else:
        carry *= 3.0
    n = 1
    while (carry / n > act_budget_bytes
           and n < shape.global_batch // dp
           and (shape.global_batch // (n * 2)) % dp == 0):
        n *= 2
    return n


def _ctx_knobs(cfg: ModelConfig, shape: InputShape, plan) -> Dict[str, Any]:
    mode = attn_mode_for(cfg, plan)
    s = shape.seq_len
    if shape.kind == "prefill":
        chunk = 1024   # fp32 score tile = b_loc*h_loc*chunk^2*4B, keep <~1GB
    else:
        chunk = 512
    loss_chunk = min(512, s)
    if mode == "context":   # keep loss chunks aligned with sequence shards
        loss_chunk = max(s // plan.tp_size, 1)
    return dict(chunk_q=chunk, chunk_k=chunk, loss_chunk=loss_chunk)


def _ensure_world(n_ranks: int) -> None:
    """Join a fake process group of ``n_ranks`` as rank 0, once per
    process: it lives until the process ends, as the reference's host
    devices do."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(f"this process is in a group of "
                               f"{dist.get_world_size()} ranks, the mesh "
                               f"needs {n_ranks}")
        return
    hlo_cost.init_fake_world(n_ranks)


def record_step(cfg: ModelConfig, shape: InputShape, mesh,
                long_ctx: bool = False, n_micro_override: int = 0,
                grad_wire_bf16: bool = False,
                bf16_momentum: bool = False) -> hlo_cost.Program:
    """Place params and inputs on ``mesh`` (a CPU mesh of a fake process
    group) as fake shards and record one call of ``shape``'s step."""
    plan = make_plan(mesh)
    ctx = make_run_ctx(cfg, plan, device="cpu",
                       **_ctx_knobs(cfg, shape, plan))
    mode = hlo_cost.fake_mode()
    params_meta = init_params(None, cfg, dtype=torch.bfloat16,
                              device="meta")
    p_specs = param_specs(params_meta, cfg, plan)
    with mode:
        params = distribute(hlo_cost.fake_cpu(params_meta, mode), p_specs,
                            mesh)

    if shape.kind in ("train", "prefill"):
        batch_meta = train_batch_specs(cfg, shape, weighted=True)
        b_specs = batch_specs(cfg, plan, batch_meta,
                              seq_sharded=ctx.seq_sharded)
        with mode:
            batch = distribute(hlo_cost.fake_cpu(batch_meta, mode), b_specs,
                               mesh)
        if shape.kind == "train":
            mom_dt = torch.bfloat16 if bf16_momentum else torch.float32
            with mode:
                opt = sgdm_init(params, mom_dtype=mom_dt)
                step_t = torch.zeros((), dtype=torch.int32)
            n_micro = n_micro_override or pick_n_micro(cfg, shape, plan)
            step = make_train_step(
                cfg, ctx,
                lambda g, s_, p, lr: sgdm_update(g, s_, p, lr=lr,
                                                 momentum=0.9),
                lambda t: 1e-3, n_micro=n_micro,
                grad_shardings=named(params, p_specs, mesh),
                grad_wire_bf16=grad_wire_bf16)
            return hlo_cost.record(step, params, opt, batch, step_t)

        # prefill: forward + last-token logits (sampling-ready)
        def prefill(params, batch):
            extras = {k: batch[k] for k in EXTRA_INPUTS if k in batch}
            h, _ = forward_hidden(params, batch["tokens"], cfg, ctx,
                                  **extras)
            return logits_fn(params, h[:, -1:], cfg)

        return hlo_cost.record(prefill, params, batch)

    # decode
    toks_meta, cache_meta = decode_inputs(cfg, shape, ctx, long_ctx)
    with mode:
        cache = distribute(hlo_cost.fake_cpu(cache_meta, mode),
                           cache_specs(cfg, plan, cache_meta), mesh)
        toks = distribute(hlo_cost.fake_cpu(toks_meta, mode),
                          batch_specs(cfg, plan, toks_meta,
                                      seq_sharded=False), mesh)
    pattern = cfg.pattern_for_long_context() if long_ctx else None

    def serve_step(params, cache, batch):
        return decode_step(params, cache, batch["tokens"], cfg, ctx,
                           pattern=pattern)

    return hlo_cost.record(serve_step, params, cache, toks)


def lower_one(arch: str, shape_name: str, multi_pod: bool,
              n_micro_override: int = 0, grad_wire_bf16: bool = False,
              bf16_momentum: bool = False):
    """-> (cfg, shape, mesh, program) of one production combination."""
    _ensure_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    program = record_step(cfg, shape, mesh, shape_name == "long_500k",
                          n_micro_override, grad_wire_bf16, bf16_momentum)
    return cfg, shape, mesh, program


def analyse(cfg: ModelConfig, shape: InputShape, mesh,
            program: hlo_cost.Program, arch: str,
            shape_name: str) -> Dict[str, Any]:
    chips = mesh.size()
    walk = hlo_cost.analyze(program)
    coll = hlo_analysis.collective_bytes(program)
    coll["total_looped"] = walk["collective_bytes"]
    terms = hlo_analysis.roofline(walk["flops"], walk["bytes"],
                                  walk["collective_bytes"])
    # MODEL_FLOPS / counted flops
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        mf = hlo_analysis.model_flops(n_active,
                                      shape.global_batch * shape.seq_len,
                                      "train")
    elif shape.kind == "prefill":
        mf = hlo_analysis.model_flops(n_active,
                                      shape.global_batch * shape.seq_len,
                                      "decode")  # 2ND forward-only
    else:
        mf = hlo_analysis.model_flops(n_active, shape.global_batch, "decode")
    mf_per_chip = mf / chips
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(int(n)) for n in mesh.shape), "chips": chips,
        "attn_mode": attn_mode_for(cfg, make_plan(mesh)),
        "flops_per_chip": walk["flops"], "bytes_per_chip": walk["bytes"],
        "transcendentals_per_chip": walk["transcendentals"],
        "flop_counter_raw": program.flop_counter,
        "collective": coll,
        "memory": {"argument_bytes": program.argument_bytes,
                   "output_bytes": program.output_bytes,
                   "peak_bytes_est": program.peak_bytes},
        "roofline": terms,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / walk["flops"])
        if walk["flops"] else 0.0,
        "params_total": cfg.param_count(), "params_active": n_active,
        "cpu_alltoall_as_allgather": program.cpu_alltoall_as_allgather,
        "unknown_ops": sorted(program.unknown),
        "n_ops": len(program.ops),
    }


def write_artifact(cfg: ModelConfig, shape: InputShape, mesh,
                   program: hlo_cost.Program, arch: str, shape_name: str,
                   out_dir: str, t0: float, save_hlo: bool = False,
                   tag_suffix: str = "", n_micro_override: int = 0,
                   grad_wire_bf16: bool = False) -> Dict[str, Any]:
    """Analyse ``program`` and write ``<arch>__<shape>__<mesh>.json`` (and
    the program as ``.ops.txt`` with ``save_hlo``); ``t0`` is when the
    combination started."""
    rec = analyse(cfg, shape, mesh, program, arch, shape_name)
    rec["n_micro"] = n_micro_override or pick_n_micro(cfg, shape,
                                                      make_plan(mesh))
    rec["grad_wire_bf16"] = grad_wire_bf16
    rec["compile_s"] = time.time() - t0
    rec["record_s"] = program.seconds
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{rec['mesh']}{tag_suffix}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if save_hlo:
        with open(os.path.join(out_dir, tag + ".ops.txt"), "w") as f:
            f.write(program.text())
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            save_hlo: bool = False, tag_suffix: str = "",
            n_micro_override: int = 0,
            grad_wire_bf16: bool = False,
            bf16_momentum: bool = False) -> Dict[str, Any]:
    t0 = time.time()
    cfg, shape, mesh, program = lower_one(arch, shape_name, multi_pod,
                                          n_micro_override, grad_wire_bf16,
                                          bf16_momentum)
    return write_artifact(cfg, shape, mesh, program, arch, shape_name,
                          out_dir, t0, save_hlo, tag_suffix,
                          n_micro_override, grad_wire_bf16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the recorded program, one op a line, "
                         "as <tag>.ops.txt")
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--bf16-grad-wire", action="store_true")
    ap.add_argument("--tag-suffix", default="")
    ap.add_argument("--bf16-momentum", action="store_true")
    args = ap.parse_args(argv)
    try:
        rec = run_one(args.arch, args.shape, args.multi_pod, args.out,
                      args.save_hlo, tag_suffix=args.tag_suffix,
                      n_micro_override=args.n_micro,
                      grad_wire_bf16=args.bf16_grad_wire,
                      bf16_momentum=args.bf16_momentum)
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)
    r = rec["roofline"]
    print(f"OK {args.arch} {args.shape} mesh={rec['mesh']} "
          f"compile={rec['compile_s']:.1f}s "
          f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
          f"collective={r['collective_s']:.4f}s bottleneck={r['bottleneck']} "
          f"peakMB={rec['memory'].get('peak_bytes_est', 0)/1e6:.0f} "
          f"useful={rec['useful_flops_ratio']:.2f}")


if __name__ == "__main__":
    main()

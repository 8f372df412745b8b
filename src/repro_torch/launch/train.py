"""Training launcher: real runs of a model of the registry, on the H100 by
default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 50 --batch 16 --seq 128 [--scadles] [--dist S1] [--ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --scadles --ckpt /tmp/ckpt

Counterpart of ``repro/launch/train.py``, with its flags, its printed lines
and its program: random f32 params from ``--seed``, Adam (weight decay
0.01) under ``warmup_cosine(lr, max(steps // 10, 1), steps)``, batches
from ``TokenData`` drawn by ``np.random.default_rng(seed)``, remat and
chunks of ``min(128, seq)``.  With ``--scadles`` each sample is mapped to
one of ``--n-virtual-devices`` streaming devices of Table I's ``--dist``,
and its loss weight is its device's rate over the batch's total (Eqn 4a),
drawn as the reference draws them, so the weights are bit-identical at
equal seeds.  The reference's docstring also promises the linear LR
scaling rule under ``--scadles``, but never applies it; neither does the
port.  At step 0 the warmup gives lr 0, so the first step moves no param
(it does update Adam's moments).  ``--ckpt DIR`` saves ``{"params":
params}`` under the config's name.  Without CUDA it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core import TABLE_I, StreamSimulator
from repro_torch.data import TokenData
from repro_torch.models.transformer import (RunCtx, init_params,
                                            param_count_tree)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--scadles", action="store_true")
    ap.add_argument("--dist", default="S1")
    ap.add_argument("--n-virtual-devices", type=int, default=8)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def train(args, params=None, log: Callable[[str], None] = print):
    """Run ``args.steps`` steps -> (params, opt_state, history).

    ``params`` replaces the random init (a caller that starts two runs from
    the same params passes them here: the CPU's and the card's generators
    draw different streams).  ``history`` holds each step's metrics as
    floats (``loss``, ``aux``, ``total``, ``grad_norm``, ``lr``).  Lines
    go to ``log``.
    """
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    chunk = min(128, args.seq)
    ctx = RunCtx(remat=True, loss_chunk=chunk, chunk_q=chunk, chunk_k=chunk,
                 device=str(dev))
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(gen, cfg, device=dev)
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    log(f"arch={cfg.name} params={param_count_tree(params) / 1e6:.1f}M "
        f"devices={n_devices}")

    opt_init, opt_update = make_optimizer("adam", weight_decay=0.01)
    opt_state = opt_init(params)
    schedule = warmup_cosine(args.lr, max(args.steps // 10, 1), args.steps)
    step_fn = make_train_step(cfg, ctx, opt_update, schedule)

    data = TokenData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     seed=args.seed)
    rng = np.random.default_rng(args.seed)
    sim = StreamSimulator(TABLE_I[args.dist], args.n_virtual_devices,
                          seed=args.seed) if args.scadles else None

    history = []
    t0 = time.time()
    for step in range(args.steps):
        toks, labels = data.sample(rng, args.batch)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if sim is not None:
            # map each sample to a virtual streaming device; weight = Eqn 4a
            rates = sim.rates_at(step)
            devs = rng.integers(0, args.n_virtual_devices, size=args.batch)
            w = rates[devs].astype(np.float64)
            batch["sample_weights"] = torch.from_numpy(
                (w / w.sum()).astype(np.float32)).to(dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        history.append(metrics)
        if step % 10 == 0 or step == args.steps - 1:
            log(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / (step + 1):.2f}s/it)")
    history = [{k: float(v) for k, v in m.items()} for m in history]
    if args.ckpt:
        path = save_pytree({"params": params}, args.ckpt, name=cfg.name)
        log(f"saved {path}")
    return params, opt_state, history


def main(argv: Optional[List[str]] = None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()

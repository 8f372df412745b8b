"""Quickstart on the PyTorch port: train a reduced assigned-architecture on
synthetic LM data.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch qwen2-0.5b]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of ``examples/quickstart.py`` on ``repro_torch``, with its
flags, printed lines and assertion: config registry -> model init ->
train-step factory -> optimizer -> loss curve.  Runs on the CUDA card
unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import TokenData
from repro_torch.models import RunCtx, init_params, param_count_tree
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    ctx = RunCtx(remat=False, chunk_q=64, chunk_k=64, loss_chunk=64,
                 device=str(dev))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    print(f"{cfg.name}: {param_count_tree(params)/1e6:.1f}M params")

    opt_init, opt_update = make_optimizer("adam")
    opt_state = opt_init(params)
    step = make_train_step(cfg, ctx, opt_update,
                           warmup_cosine(3e-3, 5, args.steps))

    data = TokenData(vocab_size=cfg.vocab_size, seq_len=64, determinism=0.9)
    rng = np.random.default_rng(0)
    losses = []
    for t in range(args.steps):
        toks, labels = data.sample(rng, 8)
        params, opt_state, m = step(
            params, opt_state,
            {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}, t)
        losses.append(float(m["loss"]))
        if t % 5 == 0:
            print(f"step {t:3d}  loss {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"done: {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()

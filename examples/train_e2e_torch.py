"""End-to-end training run on the PyTorch port: a ~100M-class model for
a few hundred steps.

    PYTHONPATH=src python examples/train_e2e_torch.py          # small default
    PYTHONPATH=src python examples/train_e2e_torch.py --full   # xlstm-125m, 200 steps
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu

The counterpart of ``examples/train_e2e.py``: the ScaDLES-integrated
launcher (``repro_torch.launch.train``; per-sample rate weights) on the
synthetic bigram LM stream, with the original's arguments, checkpointing
to ``artifacts/ckpt`` at the end.  Runs on the CUDA card unless
``--device cpu`` is given.
"""
import argparse

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full xlstm-125m, 200 steps (slow on CPU)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.full:
        steps = args.steps or 200
        train_argv = ["--arch", "xlstm-125m", "--steps", str(steps),
                      "--batch", "8", "--seq", "256", "--scadles",
                      "--ckpt", "artifacts/ckpt"]
    else:
        steps = args.steps or 60
        train_argv = ["--arch", "xlstm-125m", "--reduced",
                      "--steps", str(steps), "--batch", "16", "--seq", "128",
                      "--scadles", "--ckpt", "artifacts/ckpt"]
    train.main(train_argv + ["--device", args.device])


if __name__ == "__main__":
    main()

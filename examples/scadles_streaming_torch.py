"""The paper, end to end, on the PyTorch port: 16 edge devices with
heterogeneous streams.

    PYTHONPATH=src python examples/scadles_streaming_torch.py [--dist S1]
    PYTHONPATH=src python examples/scadles_streaming_torch.py \
        --skew dirichlet --alpha 0.1        # non-IID label-skewed streams
    PYTHONPATH=src python examples/scadles_streaming_torch.py --device cpu

The counterpart of ``examples/scadles_streaming.py`` on ``repro_torch``:
the full ScaDLES per-iteration routine (Fig 5) vs conventional DDL with
rate-proportional batching + weighted aggregation (Eqn 4), stream
truncation and adaptive Top-k compression (CR=0.1, delta=0.3), and the
Table-VI-style summary: accuracy delta, buffer reduction, simulated
wall-clock speedup.  The edge MLP is ``repro_torch.models.mlp.make_mlp``.

With ``--skew`` the devices stream from a ``repro_torch.streamdata``
non-IID partition instead of the shared IID pool (``dirichlet``:
Dirichlet(α) label skew; ``shard``: pathological one-class shards;
``quantity``: skewed sample counts) and the ScaDLES arm turns on
skew-corrected aggregation.  The trainers' tensors live on the CUDA card
unless ``--device cpu`` is given; the sim clock and the streams are the
host's.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (PERSISTENCE, TRUNCATION, ScaDLESConfig,
                              ScaDLESTrainer)
from repro_torch.data import ClassClusterData
from repro_torch.models.mlp import make_mlp
from repro_torch.streamdata import make_stream_source


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dist", default="S1", choices=["S1", "S2", "S1p", "S2p"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--skew", default="iid",
                    choices=["iid", "dirichlet", "shard", "quantity"],
                    help="per-device stream distribution family "
                         "(iid matches the legacy pooled stream bit-exactly)")
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet concentration for dirichlet/quantity "
                         "skew (smaller = more skewed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    data = ClassClusterData(num_classes=10, train_per_class=192, noise=0.8)
    model = make_mlp()
    src = make_stream_source(data, args.devices, skew=args.skew,
                             alpha=args.alpha, seed=0)
    noniid = args.skew != "iid"

    scadles = ScaDLESTrainer(model, src, ScaDLESConfig(
        n_devices=args.devices, dist=args.dist, weighted=True,
        policy=TRUNCATION, compression=(0.1, 0.3), b_max=128, base_lr=0.05,
        skew_weighting=noniid, device=args.device))
    ddl = ScaDLESTrainer(model, src, ScaDLESConfig(
        n_devices=args.devices, dist=args.dist, weighted=False,
        policy=PERSISTENCE, b_max=128, base_lr=0.05, device=args.device))

    tag = f", {args.skew}" + (f" a={args.alpha}" if noniid else "")
    print(f"== ScaDLES ({args.dist}, {args.devices} devices{tag}) ==")
    hist = scadles.run(args.steps)
    print(f"   sim time {scadles.clock.time_s:8.1f}s  "
          f"buffer {scadles.summary()['buffer_final']:9.0f} samples  "
          f"CNC {scadles.summary()['cnc_ratio']:.2f}")
    if noniid:
        print(f"   label divergence (TV to global mix): "
              f"mean {hist[-1]['label_div_mean']:.2f}  "
              f"max {hist[-1]['label_div_max']:.2f}  "
              f"(skew-corrected weighting on)")
    print("== conventional DDL ==")
    ddl.run(args.steps)
    print(f"   sim time {ddl.clock.time_s:8.1f}s  "
          f"buffer {ddl.summary()['buffer_final']:9.0f} samples")

    def acc(tr):
        x = torch.as_tensor(data.test_x, device=tr.device)
        logits = model["predict"](tr.params, x)
        return float(np.mean(np.argmax(logits.cpu().numpy(), -1)
                             == data.test_y))

    a_s, a_d = acc(scadles), acc(ddl)
    print("\n== Table-VI style summary ==")
    print(f"accuracy: scadles={a_s:.3f} ddl={a_d:.3f} (drop {a_s-a_d:+.3f})")
    print(f"buffer reduction: "
          f"{ddl.summary()['buffer_final']/max(scadles.summary()['buffer_final'],1):.0f}x")
    print(f"speedup: {ddl.clock.time_s/scadles.clock.time_s:.2f}x "
          f"(paper band: 1.15-3.29x)")


if __name__ == "__main__":
    main()

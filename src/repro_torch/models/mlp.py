"""The edge MLP that ``ScaDLESTrainer`` trains: a CPU-scale stand-in for the
paper's ResNet152/VGG19 on CIFAR (``benchmarks/common.py::make_mlp`` in the
reference).

At its own width (d_in 3 072 = 32 x 32 x 3, hidden 64, 10 classes) it has
197 322 parameters.  The dict it returns has the reference's three entries:

* ``init(gen, device="cuda")``: params from a ``torch.Generator`` (drawn on
  the generator's device, then moved), so equal seeds give equal params on
  every device;
* ``per_sample_loss(p, x, y)``: (b,) cross-entropy losses;
* ``predict(p, x)``: (b, classes) logits.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def make_mlp(d_in: int = 32 * 32 * 3, hidden: int = 64, classes: int = 10):
    def init(gen: torch.Generator, device="cuda"):
        dev = resolve_device(device)
        w1 = torch.randn((d_in, hidden), generator=gen) * 0.02
        w2 = torch.randn((hidden, classes), generator=gen) * 0.02
        return {"w1": w1.to(dev), "b1": torch.zeros(hidden, device=dev),
                "w2": w2.to(dev), "b2": torch.zeros(classes, device=dev)}

    def predict(p, x):
        h = torch.relu(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def per_sample_loss(p, x, y):
        logits = predict(p, x)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
        return lse - gold

    return {"init": init, "per_sample_loss": per_sample_loss,
            "predict": predict}

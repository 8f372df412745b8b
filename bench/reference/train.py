"""The plain reference of the compressed and the dense DDP step.

One rank of ScaDLES's data-parallel step (world size 1): the gradient of the
mean next-token loss, weighted by the rank's share of the stream rates; for
the compressed step the exact top-k of the flat gradient's magnitudes (k =
max(1, int(cr * n))), scattered back into a dense vector; then momentum
SGD (m = mu m + g; p = p - lr m).  It follows the first ``n_steps`` steps
from the given weights and batches and returns what ``correct`` compares:
each step's loss, each leaf's first gradient as the optimizer gets it (its
momentum after one step), the raw first gradient, and each leaf's change
after the last step.

``rows`` keeps only those rows of every batch (the fault "half of the batch
left out, the mean taken over the rest" is ``slice(0, b // 2)``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from bench.reference.model import Decoder
from bench.weights import flat_leaves


def _tree(paths, values) -> Dict:
    tree: Dict = {}
    for path, v in zip(paths, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree


def _norms(paths, flat, sizes) -> Dict[Tuple[str, ...], float]:
    return {p: float(torch.linalg.vector_norm(part.double()))
            for p, part in zip(paths, torch.split(flat, sizes))}


def ddp_steps(cfg: dict, weights: Dict, batches: Sequence[Tuple],
              *, lr: float, momentum: float, cr: Optional[float],
              rates: Sequence[float] = (1.0,), rank: int = 0,
              n_steps: int = 3, precision: str = "f32",
              rows: Optional[slice] = None) -> Dict:
    """``cr`` None: the dense step; otherwise the compressed one."""
    paths, tensors = zip(*flat_leaves(weights))
    sizes = [t.numel() for t in tensors]
    shapes = [t.shape for t in tensors]
    p = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    p0 = p.clone()
    mom = torch.zeros_like(p)
    n = p.numel()
    k = max(1, int(cr * n)) if cr is not None else None
    w = float(rates[rank]) / max(float(sum(rates)), 1e-9)
    out = {"loss": []}
    for step, (tokens, labels) in enumerate(batches[:n_steps]):
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        live = [part.view(shape).clone().requires_grad_()
                for part, shape in zip(torch.split(p, sizes), shapes)]
        model = Decoder(cfg, _tree(paths, live), precision)
        loss = model.loss(tokens, labels)
        grads = torch.autograd.grad(loss, live)
        del model, live
        g = torch.cat([x.reshape(-1) for x in grads]) * w
        del grads
        out["loss"].append(float(loss.detach()))
        if k is not None:
            _, idx = torch.topk(g.abs(), k, sorted=False)
            sparse = torch.zeros_like(g)
            sparse[idx] = g[idx]
            sent = sparse
        else:
            sent = g
        mom = momentum * mom + sent
        p = p - lr * mom
        if step == 0:
            out["raw_grad"] = _norms(paths, g, sizes)
            out["first_grad"] = _norms(paths, mom, sizes)
        del g, sent
    out["change"] = _norms(paths, p - p0, sizes)
    out["k"], out["n"] = k, n
    return out

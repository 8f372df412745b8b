"""The numbers that decide ``correct``, each set against its limit.

Training (three steps of the program against three of the reference, from
the same weights and batches):

* ``loss_rel``: the widest relative gap of a step's loss;
* ``grad_norm_gap``: the first gradient as the optimizer gets it (its
  momentum after one step), by the worst leaf: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``change_norm_gap``: the same of each leaf's change after the three
  steps.  Leaves whose first gradient in the reference lies under a
  thousandth of the median leaf's (nought but rounding: a key's bias under
  softmax) move by rounding alone and are left out of it.

Serving: ``token_gap``, the widest gap by which a served token's logit lies
below the reference's best (``bench/reference/serve.py``).
"""
from __future__ import annotations

import statistics
from typing import Dict, Tuple

import torch

from bench.weights import flat_leaves

NOUGHT = 1e-3


def leaf_norms(tree) -> Dict[Tuple[str, ...], float]:
    """Each leaf's norm, accumulated in float64."""
    return {path: float(torch.linalg.vector_norm(v.detach().double()))
            for path, v in flat_leaves(tree)}


def norm_gap(got: Dict, want: Dict, leaves=None) -> float:
    keys = sorted(want) if leaves is None else sorted(leaves)
    floor = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], floor, 1e-300)
               for k in keys)


def moving_leaves(raw_grad: Dict) -> list:
    """Leaves whose reference gradient is more than rounding."""
    med = statistics.median(raw_grad.values())
    return [k for k, v in raw_grad.items() if v >= NOUGHT * med]


def compare_train(got: Dict, ref: Dict) -> Dict[str, float]:
    """``got`` and ``ref``: {"loss": [per step], "first_grad": {leaf: norm},
    "change": {leaf: norm}}; ``ref`` also has "raw_grad"."""
    if len(got["loss"]) != len(ref["loss"]):
        raise ValueError("the program and the reference ran different steps")
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    return {"loss_rel": loss,
            "grad_norm_gap": norm_gap(got["first_grad"], ref["first_grad"]),
            "change_norm_gap": norm_gap(got["change"], ref["change"],
                                        moving_leaves(ref["raw_grad"]))}


def judged(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limit of the cell; a number
    that is missing or not finite reads as infinite."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, float("inf"))
        if v != v:          # NaN
            v = float("inf")
        out[name] = {"value": v, "limit": float(limit)}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())

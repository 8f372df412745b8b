"""The general traffic generator: what each cell's workload file asks for,
made from ``--seed``.

* Training: a stream of global batches, each ``batch`` rows of ``seq + 1``
  token ids drawn uniformly from the vocabulary (inputs the first ``seq``,
  labels the last ``seq``), so every row of every step differs.
* Serving: a pool of requests whose prompt and output lengths are the
  ``pool`` quantiles of the workload's distributions, each list put in an
  order drawn from the seed: every seed serves the same set of sizes, in
  another order.  Prompt ids are uniform over the vocabulary.  With
  ``steady_start`` the loop opens in its steady state with the same work in
  every seed: the n clients' first requests take the n mid-quantiles of the
  prompt law and, as output lengths, the n mid-quantiles of the
  forward-recurrence distribution of the output law (the remaining length
  of a request caught in flight), each in an order drawn from the seed; the
  next request, the window's first refill, takes the medians of both laws;
  the pool follows.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, Iterator, List, Tuple

import numpy as np

from bench.weights import sub_seed

DATA_STREAM = 2
ORDER_STREAM = 3


def train_batches(seed: int, batch: int, seq: int,
                  vocab: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(sub_seed(seed, DATA_STREAM))
    while True:
        rows = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
        yield rows[:, :-1], rows[:, 1:]


def quantile_lengths(spec: Dict, n: int) -> np.ndarray:
    """The n mid-quantiles ((i + 0.5) / n) of a length distribution, as
    integers of at least 1: ``{"dist": "uniform" | "log_uniform", "min",
    "max"}``, or ``{"dist": "log_normal", "median", "mean"}`` (the
    log-normal law with that median and mean)."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "log_normal":
        median, mean = float(spec["median"]), float(spec["mean"])
        sigma = math.sqrt(2.0 * math.log(mean / median))
        z = np.array([statistics.NormalDist().inv_cdf(q) for q in u])
        return np.maximum(np.rint(median * np.exp(sigma * z)), 1).astype(
            np.int64)
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if spec["dist"] == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return np.minimum(np.floor(x).astype(np.int64), hi)
    raise ValueError(f"length distribution {spec['dist']!r}")


def residual_lengths(lengths: np.ndarray, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """The n mid-quantiles of the remaining length of a request caught in
    flight (P(r) proportional to the share of ``lengths`` that are >= r),
    in an order drawn from ``rng``."""
    r = np.arange(1, int(lengths.max()) + 1)
    cdf = np.cumsum([(lengths >= x).mean() for x in r])
    q = r[np.searchsorted(cdf / cdf[-1], (np.arange(n) + 0.5) / n)]
    return rng.permutation(q)


@dataclasses.dataclass
class Req:
    rid: int
    prompt: np.ndarray        # (P,) int64
    max_new: int


class RequestPool:
    """Requests in the order the closed loop takes them; ``next()`` gives
    the next one (the pool repeats in a new order if a run outlasts it)."""

    def __init__(self, wl: Dict, seed: int, vocab: int):
        self.n = int(wl["pool"])
        self.prompts = quantile_lengths(wl["prompt_len"], self.n)
        self.outputs = quantile_lengths(wl["output_len"], self.n)
        self.vocab = vocab
        self.order = np.random.default_rng(sub_seed(seed, ORDER_STREAM))
        self.data = np.random.default_rng(sub_seed(seed, DATA_STREAM))
        self.queue: List[Tuple[int, int]] = []
        self.issued = 0
        if wl.get("steady_start"):
            n = int(wl["clients"])
            fills = self.order.permutation(
                quantile_lengths(wl["prompt_len"], n))
            left = residual_lengths(self.outputs, n, self.order)
            self.queue = list(zip(fills.tolist(), left.tolist())) + [(
                int(quantile_lengths(wl["prompt_len"], 1)[0]),
                int(quantile_lengths(wl["output_len"], 1)[0]))]

    def _refill(self) -> None:
        self.queue = list(zip(self.order.permutation(self.prompts).tolist(),
                              self.order.permutation(self.outputs).tolist()))

    def next(self) -> Req:
        if not self.queue:
            self._refill()
        p_len, out = self.queue.pop(0)
        rid = self.issued
        self.issued += 1
        prompt = self.data.integers(0, self.vocab, size=p_len, dtype=np.int64)
        return Req(rid, prompt, int(out))

"""The general traffic generator: what each cell's workload file asks for,
made from ``--seed``.

* Training: a stream of global batches, each ``batch`` rows of ``seq + 1``
  token ids drawn uniformly from the vocabulary (inputs the first ``seq``,
  labels the last ``seq``), so every row of every step differs.
* Serving: a pool of requests whose prompt and output lengths are the
  ``pool`` mid-quantiles of the workload's distributions, served pass after
  pass in one fixed order that no seed changes: the prompt quantiles in the
  order of the base-2 radical inverse of their position (bit reversal, for
  a power of two), the output quantiles in that of the base-3 one.  So any
  short run of consecutive requests spreads over both laws, and long
  prompts do not pair with long outputs.  Every seed serves the same
  lengths in the same order; the seed draws the prompt ids alone, uniform
  over the vocabulary.  With ``steady_start`` the loop opens in its steady
  state: the n clients' first requests take the n mid-quantiles of the
  prompt law and, as output lengths, the n mid-quantiles of the
  forward-recurrence distribution of the output law (the remaining length
  of a request caught in flight), in the same two orders; the next
  request, the window's first refill, takes the medians of both laws; the
  pool follows.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, Iterator, List, Tuple

import numpy as np

from bench.weights import sub_seed

DATA_STREAM = 2


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


def residual_lengths(lengths: np.ndarray, n: int) -> np.ndarray:
    """The n mid-quantiles, ascending, of the remaining length of a request
    caught in flight (P(r) proportional to the share of ``lengths`` that
    are >= r)."""
    r = np.arange(1, int(lengths.max()) + 1)
    cdf = np.cumsum([(lengths >= x).mean() for x in r])
    return r[np.searchsorted(cdf / cdf[-1], (np.arange(n) + 0.5) / n)]


def spread_order(n: int, base: int) -> np.ndarray:
    """For each position k in 0..n-1, the rank of k's base-``base``
    radical inverse among them: ``x[spread_order(n, b)]`` takes an
    ascending ``x`` in an order of which every short run spreads over the
    whole range."""
    def radical_inverse(k: int) -> float:
        x, f = 0.0, 1.0 / base
        while k:
            k, d = divmod(k, base)
            x += d * f
            f /= base
        return x
    return np.argsort([radical_inverse(k) for k in range(n)]).argsort()


@dataclasses.dataclass
class Req:
    rid: int
    prompt: np.ndarray        # (P,) int64
    max_new: int


def fixed_pairs(prompts: np.ndarray,
                outputs: np.ndarray) -> List[Tuple[int, int]]:
    """(prompt length, output length) of ascending quantile lists, in the
    fixed order: prompts by the base-2 spread order, outputs by base 3."""
    n = len(prompts)
    return list(zip(prompts[spread_order(n, 2)].tolist(),
                    outputs[spread_order(n, 3)].tolist()))


class RequestPool:
    """Requests in the order the closed loop takes them; ``next()`` gives
    the next one (the pool repeats in the same order if a run outlasts
    it)."""

    def __init__(self, wl: Dict, seed: int, vocab: int):
        self.n = int(wl["pool"])
        self.prompts = quantile_lengths(wl["prompt_len"], self.n)
        self.outputs = quantile_lengths(wl["output_len"], self.n)
        self.vocab = vocab
        self.data = np.random.default_rng(sub_seed(seed, DATA_STREAM))
        self.queue: List[Tuple[int, int]] = []
        self.issued = 0
        if wl.get("steady_start"):
            n = int(wl["clients"])
            self.queue = fixed_pairs(quantile_lengths(wl["prompt_len"], n),
                                     residual_lengths(self.outputs, n)) + [(
                int(quantile_lengths(wl["prompt_len"], 1)[0]),
                int(quantile_lengths(wl["output_len"], 1)[0]))]

    def _refill(self) -> None:
        self.queue = fixed_pairs(self.prompts, self.outputs)

    def next(self) -> Req:
        if not self.queue:
            self._refill()
        p_len, out = self.queue.pop(0)
        rid = self.issued
        self.issued += 1
        prompt = self.data.integers(0, self.vocab, size=p_len, dtype=np.int64)
        return Req(rid, prompt, int(out))

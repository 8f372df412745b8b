"""Stream simulation: device streaming rates + Kafka-like producer semantics.

Carried over from ``repro/core/streams.py`` with its numpy logic unchanged,
so equal seeds give identical rates in both packages.  The serving slice
reads ``TABLE_I`` (``serve/requests.py``); the trainer slice will reuse the
rest.

Reproduces the paper's Table I rate distributions.  A uniform distribution
with mean m and std s spans [m - sqrt(3) s, m + sqrt(3) s] (clipped to >= 1
sample/s); normal is N(m, s) clipped likewise.  Rates can vary intra-device
over time ("battery level, time of day, usage") via a bounded random walk.

The optional ``producer_contention`` models Fig 6: with many concurrent
producers the *effective* rate saturates below the target (we fit a soft cap
matching the paper's 600 samples/s observation beyond 16 streams).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

SQRT3 = 3.0 ** 0.5


@dataclasses.dataclass(frozen=True)
class StreamDist:
    """A named streaming-rate distribution (paper Table I).

    ``min_rate`` calibrates the slowest sampled device: the paper reports the
    exact (mean, std) of its sampled sets but not the realised minima; a floor
    of ~12 samples/s reproduces Fig 1's latency range and keeps DDL-vs-ScaDLES
    speedups in the paper's 1.15-3.3x band (EXPERIMENTS.md §Calibration).
    """
    name: str
    kind: str      # "uniform" | "normal"
    mean: float
    std: float
    min_rate: float = 12.0

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "uniform":
            lo, hi = self.mean - SQRT3 * self.std, self.mean + SQRT3 * self.std
            r = rng.uniform(lo, hi, size=n)
        elif self.kind == "normal":
            r = rng.normal(self.mean, self.std, size=n)
        else:
            raise ValueError(self.kind)
        return np.maximum(np.round(r), self.min_rate).astype(np.int64)


TABLE_I = {
    "S1": StreamDist("S1", "uniform", 38.0, 24.0),
    "S2": StreamDist("S2", "uniform", 300.0, 112.0),
    "S1p": StreamDist("S1p", "normal", 64.0, 24.0),
    "S2p": StreamDist("S2p", "normal", 256.0, 28.0),
}


def streaming_latency(rate: np.ndarray, batch: int) -> np.ndarray:
    """Seconds to gather ``batch`` samples at ``rate`` samples/s (Fig 1)."""
    return batch / np.asarray(rate, dtype=np.float64)


@dataclasses.dataclass
class StreamSimulator:
    """Per-device sample streams with optional intra-device drift.

    Determinism contract: all randomness (rate sampling at construction, the
    jitter random walk) flows through one ``np.random.Generator``.  Pass an
    explicit ``rng`` to own the stream — two simulators built from generators
    seeded identically produce bit-identical rate traces (the sharded loader
    and the bit-exactness tests rely on this); ``seed`` is the convenience
    path and constructs ``default_rng(seed)``.

    ``rate_curve`` composes a sim-time multiplier onto every device's rate —
    diurnal day/night cycles, quantity-skew capacity scaling
    (the reference's ``streamdata/generators.py``).  It receives the absolute sim time and
    returns a scalar or per-device ``(n_devices,)`` factor; ``rates_at`` only
    applies it when the caller supplies ``t_sim``, so step-indexed legacy
    callers are unchanged.
    """
    dist: StreamDist
    n_devices: int
    seed: int = 0
    intra_jitter: float = 0.0        # fraction of base rate per step (random walk)
    producer_contention: bool = False
    rng: Optional[np.random.Generator] = None
    rate_curve: Optional[Callable[[float], np.ndarray]] = None

    def __post_init__(self):
        self._rng = self.rng if self.rng is not None \
            else np.random.default_rng(self.seed)
        self.base_rates = self.dist.sample(self._rng, self.n_devices)
        self._drift = np.zeros(self.n_devices)

    def rates_at(self, step: int, t_sim: Optional[float] = None) -> np.ndarray:
        r = self.base_rates.astype(np.float64)
        if self.intra_jitter > 0:
            self._drift = np.clip(
                self._drift + self._rng.normal(
                    0.0, self.intra_jitter, self.n_devices),
                -3 * self.intra_jitter, 3 * self.intra_jitter)
            r = r * (1.0 + self._drift)
        if self.rate_curve is not None and t_sim is not None:
            r = r * np.maximum(np.asarray(self.rate_curve(float(t_sim)),
                                          np.float64), 0.0)
        if self.producer_contention:
            r = effective_rate(r, self.n_devices)
        return np.maximum(np.round(r), 1.0).astype(np.int64)


def arrivals(rates: np.ndarray, duration: float,
             online_frac: Optional[np.ndarray] = None) -> np.ndarray:
    """Samples arriving at each device over ``duration`` seconds.

    ``online_frac`` (from the fleet engine's churn model) scales each device's
    effective streaming time by the fraction of the interval it was up — a
    device that was offline half the round gathers half the samples."""
    out = np.asarray(rates, np.float64) * max(duration, 1.0)
    if online_frac is not None:
        out = out * np.asarray(online_frac, np.float64)
    return out


def effective_rate(target: np.ndarray, n_streams: int,
                   broker_capacity: float = 10_000.0) -> np.ndarray:
    """Fig 6: effective rate saturates when aggregate demand exceeds broker
    capacity (observed at 600 samples/s x >16 concurrent producers)."""
    demand = float(np.sum(target))
    if demand <= broker_capacity:
        return target
    return target * (broker_capacity / demand)

"""Per-device streaming sample sources on the sim clock.

A ``StreamingDataSource`` composes a non-IID ``Partition`` with the
trainer's stream-rate process (``core.streams.StreamSimulator``): rates say
*how many* samples arrive per sim second, the partition says *which* samples
they are.  It implements the trainer's data interface —
``batches(rng, batch_sizes, b_max)`` — plus the streamdata extensions the
trainer discovers by attribute:

* ``time_aware = True``  — the trainer passes ``t_sim`` so the source can
  drift its per-device distributions over simulated time;
* ``label_divergence()`` — per-device TV distance to the global label mix
  *at the current sim time*, feeding skew-corrected aggregation weights,
  non-IID staleness damping, and fleet/controller telemetry.

IID equivalence (bit-exactness contract): with ``iid=True`` the source
replays ``repro_torch.data.DeviceDataSource(iid=True)``'s rng sequence
exactly — same index draw, same ``augment_batch`` calls — so a streamdata-fed
homogeneous full-sync run is bit-identical to the legacy synthetic path
(tests enforce this).

Distribution drift (``DriftSpec``): device mixes move over sim time,
modelling edge streams whose content follows the environment (a traffic
camera at rush hour vs 3am).  ``toward-uniform`` fades each device's skewed
pool into the global pool; ``rotate`` morphs device i's stream toward device
(i+1)'s pool — total skew is conserved but *which* skew each device sees
changes, the adversarial case for skew-corrected weighting.

Rate curves (for ``StreamSimulator.rate_curve``): ``DiurnalCurve`` is the
paper-motivated day/night cycle ("battery level, time of day, usage"),
``quantity_rate_curve`` ties stream rates to partition shares so
quantity-skewed devices also stream proportionally to the data they hold,
and ``compose_curves`` multiplies any number of them.

Carried over from ``repro/streamdata/generators.py`` with its numpy logic
unchanged: equal seeds give identical curves, drift states and batches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import ClassClusterData, augment_batch
from repro_torch.streamdata.partition import (Partition, label_divergence,
                                              make_partition)


# ---------------------------------------------------------------------------
# rate curves


@dataclasses.dataclass(frozen=True)
class DiurnalCurve:
    """Sinusoidal day/night rate multiplier on the sim clock.

    ``1 + amplitude * sin(2π (t/day_s + phase_i))`` clipped to >= ``floor``;
    ``phase`` may be per-device (phase-shifted devices model timezones /
    usage patterns — the fleet never quiesces all at once).
    """
    day_s: float = 3600.0
    amplitude: float = 0.5
    phase: object = 0.0           # scalar or (n_devices,) fraction of a day
    floor: float = 0.05

    def __call__(self, t_sim: float) -> np.ndarray:
        ph = np.asarray(self.phase, np.float64)
        mult = 1.0 + self.amplitude * np.sin(
            2.0 * np.pi * (t_sim / self.day_s + ph))
        return np.maximum(mult, self.floor)


def quantity_rate_curve(partition: Partition) -> Callable[[float], np.ndarray]:
    """Static per-device multipliers proportional to partition shares
    (mean 1), so a quantity-skewed device streams in proportion to the data
    it holds — quantity skew becomes visible to rate-weighted aggregation."""
    shares = partition.shares()
    mult = shares * partition.n_devices
    return lambda t_sim: mult


def compose_curves(*curves: Callable[[float], np.ndarray]
                   ) -> Callable[[float], np.ndarray]:
    """Multiply rate curves elementwise (diurnal x quantity x ...)."""
    def curve(t_sim: float) -> np.ndarray:
        out = np.asarray(1.0)
        for c in curves:
            out = out * np.asarray(c(t_sim), np.float64)
        return out
    return curve


# ---------------------------------------------------------------------------
# distribution drift


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Linear-in-time mixture drift of each device's sample distribution.

    At sim time t a fraction ``w(t) = min(t / t_scale, w_max)`` of each
    device's samples are drawn from the drift target instead of its own
    pool:

    * ``toward-uniform`` — target is the global pool: skew decays, every
      device ends near-IID (divergence falls toward 0);
    * ``rotate``         — target is device (i+1 mod D)'s pool: total skew
      is conserved while each device's *direction* of skew migrates.
    """
    kind: str = "toward-uniform"
    t_scale: float = 1000.0
    w_max: float = 1.0

    def weight(self, t_sim: float) -> float:
        if self.t_scale <= 0:
            return self.w_max
        return float(min(max(t_sim, 0.0) / self.t_scale, self.w_max))


class StreamingDataSource:
    """Partition-backed per-device sampler with drift on the sim clock.

    Interface-compatible with ``repro_torch.data.DeviceDataSource`` (the
    trainer's data duck type); samples *with replacement* from each device's
    pool, so it models the stream's distribution rather than its exact
    arrival ids — use ``repro_torch.streamdata.loader.ShardedStreamLoader``
    when sample identity and buffer conservation matter.
    """

    time_aware = True

    def __init__(self, data: ClassClusterData, n_devices: int,
                 partition: Optional[Partition] = None, iid: bool = False,
                 drift: Optional[DriftSpec] = None, augment: bool = True):
        if not iid and partition is None:
            raise ValueError("non-IID StreamingDataSource needs a partition "
                             "(or pass iid=True for the shared-pool mode)")
        if drift is not None and drift.kind not in ("toward-uniform",
                                                    "rotate"):
            raise ValueError(f"unknown drift kind {drift.kind!r}; options: "
                             "['toward-uniform', 'rotate']")
        self.data = data
        self.n_devices = int(n_devices)
        self.partition = partition
        self.iid = bool(iid)
        self.drift = drift
        self.augment = augment
        self._t = 0.0                    # sim time of the last batch draw
        if partition is not None:
            self._global_pool = np.arange(len(data.train_y))

    # -- distribution bookkeeping ---------------------------------------
    def _mix_at(self, t_sim: float) -> np.ndarray:
        """(D, K) per-device class mix at sim time ``t_sim``."""
        if self.iid or self.partition is None:
            g = np.bincount(self.data.train_y,
                            minlength=self.data.num_classes)
            g = g / max(len(self.data.train_y), 1)
            return np.tile(g, (self.n_devices, 1))
        probs = self.partition.class_probs
        if self.drift is None:
            return probs
        w = self.drift.weight(t_sim)
        if self.drift.kind == "rotate":
            target = np.roll(probs, -1, axis=0)
        else:
            target = np.tile(self.partition.global_probs,
                             (self.n_devices, 1))
        return (1.0 - w) * probs + w * target

    def label_divergence(self) -> np.ndarray:
        """Per-device TV distance to the global mix at the last-drawn sim
        time (zeros in IID mode — skew corrections become no-ops)."""
        if self.iid or self.partition is None:
            return np.zeros(self.n_devices)
        return label_divergence(self._mix_at(self._t),
                                self.partition.global_probs)

    # -- sampling --------------------------------------------------------
    def _drift_target_pool(self, dev: int) -> np.ndarray:
        if self.drift is not None and self.drift.kind == "rotate":
            return self.partition.assignments[(dev + 1) % self.n_devices]
        return self._global_pool

    def _sample_device(self, rng: np.random.Generator, dev: int, n: int,
                       t_sim: float) -> Tuple[np.ndarray, np.ndarray]:
        if self.iid or self.partition is None:
            # bit-exact replay of DeviceDataSource(iid=True): one index draw
            # over the full dataset, then the shared augmentation
            idx = rng.integers(0, len(self.data.train_y), size=n)
        else:
            pool = self.partition.assignments[dev]
            idx = pool[rng.integers(0, len(pool), size=n)]
            w = self.drift.weight(t_sim) if self.drift is not None else 0.0
            if w > 0.0:
                swap = rng.random(n) < w
                k = int(swap.sum())
                if k:
                    target = self._drift_target_pool(dev)
                    idx = idx.copy()
                    idx[swap] = target[rng.integers(0, len(target), size=k)]
        x = self.data.train_x[idx]
        y = self.data.train_y[idx]
        if self.augment:
            augment_batch(rng, x)
        return x, y

    def batches(self, rng: np.random.Generator, batch_sizes: np.ndarray,
                b_max: int, t_sim: float = 0.0):
        """-> xs (D, b_max, ...), ys (D, b_max), masks (D, b_max)."""
        self._t = float(t_sim)
        D = self.n_devices
        xs = np.zeros((D, b_max) + self.data.image_shape, np.float32)
        ys = np.zeros((D, b_max), np.int32)
        masks = np.zeros((D, b_max), np.float32)
        for dev in range(D):
            n = int(min(batch_sizes[dev], b_max))
            x, y = self._sample_device(rng, dev, n, self._t)
            xs[dev, :n], ys[dev, :n], masks[dev, :n] = x, y, 1.0
        return xs, ys, masks


def make_stream_source(data: ClassClusterData, n_devices: int,
                       skew: str = "iid", alpha: float = 1.0,
                       shards_per_device: int = 1,
                       drift: Optional[DriftSpec] = None,
                       augment: bool = True, seed: int = 0
                       ) -> StreamingDataSource:
    """Factory: partition ``data`` by the named skew family and wrap it in a
    streaming source.  ``skew='iid'`` (or ``alpha=inf`` under dirichlet /
    quantity) short-circuits to the shared-pool IID mode that is bit-exact
    with the legacy ``DeviceDataSource(iid=True)`` path."""
    if skew == "iid" or (skew in ("dirichlet", "quantity")
                         and np.isinf(alpha)):
        return StreamingDataSource(data, n_devices, iid=True,
                                   augment=augment)
    part = make_partition(data.train_y, n_devices, skew=skew, alpha=alpha,
                          shards_per_device=shards_per_device, seed=seed)
    return StreamingDataSource(data, n_devices, partition=part, drift=drift,
                               augment=augment)

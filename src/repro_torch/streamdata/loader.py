"""Sharded streaming loader: shard placement -> prefetch -> bounded buffers.

The generator source (``generators.py``) models stream *distributions* by
sampling with replacement; this module is the honest input pipeline — every
arriving sample has an identity, lives in a capacity-bounded per-device
``SampleBuffer`` with the paper's drop/accumulate semantics (§IV: persistence
vs truncation, drop-oldest eviction), and is trained on at most once.
Fleet-scale input stops being synthetic-only: swap the dataset accessor and
the same machinery feeds real shards.

Structure (levanter's ``data/sharded.py`` shape, CPU-scale):

* ``make_label_shards`` cuts the dataset into contiguous sort-by-label
  shards — the on-disk layout real streaming corpora tend to have;
* a **placement callback** ``place(shard_id, n_devices) -> device`` maps
  shards to devices (round-robin recovers near-IID, ``contiguous`` gives
  pathological label skew; any callable works — placement *is* the
  partition policy);
* ``ShardedStreamLoader`` owns one ``SampleBuffer`` per device and exposes
  the trainer's streamdata hooks: ``on_arrivals(arriving)`` prefetches the
  round's arrivals into the buffers (each device cycles a deterministic
  shuffled order over its placed shards, fractional arrivals accumulate),
  and ``batches(...)`` drains ids into fixed-shape masked batches.

Conservation invariant (tested): per device,

    streamed == buffered + taken + dropped

with drops only from capacity eviction (``max_size``) or truncation.  Unlike
the generator source, a device whose buffer runs dry returns a *short*
batch — the mask tells the trainer how many samples were really available.

Carried over from ``repro/streamdata/loader.py`` with its numpy logic
unchanged: equal seeds give identical ids, buffers and counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.buffer import DROP_OLDEST, PERSISTENCE, SampleBuffer
from repro_torch.data.synthetic import ClassClusterData, augment_batch
from repro_torch.streamdata.partition import (Partition, _finish,
                                              label_divergence)


def make_label_shards(labels: np.ndarray, n_shards: int) -> List[np.ndarray]:
    """Contiguous sort-by-label shards (stable sort keeps intra-class order)."""
    order = np.argsort(np.asarray(labels), kind="stable")
    return [np.asarray(s, np.int64) for s in np.array_split(order, n_shards)]


def round_robin_placement(shard_id: int, n_devices: int) -> int:
    """Deal shards cyclically: adjacent (same-label) shards land on
    different devices — the near-IID placement."""
    return shard_id % n_devices


def contiguous_placement(n_shards: int) -> Callable[[int, int], int]:
    """Keep label-adjacent shards together: device i gets the i-th run of
    ``n_shards / n_devices`` shards — the pathological label-skew placement."""
    def place(shard_id: int, n_devices: int) -> int:
        per = max(n_shards // n_devices, 1)
        return min(shard_id // per, n_devices - 1)
    return place


@dataclasses.dataclass
class DeviceStreamState:
    """One device's view of its placed shards: a deterministic infinite
    stream (fresh shuffled pass over the pool each epoch) plus the
    fractional-arrival accumulator."""
    pool: np.ndarray
    rng: np.random.Generator
    cursor: int = 0
    frac: float = 0.0
    order: Optional[np.ndarray] = None

    def next_ids(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        filled = 0
        while filled < n:
            if self.order is None or self.cursor >= len(self.order):
                self.order = self.pool[self.rng.permutation(len(self.pool))]
                self.cursor = 0
            take = min(n - filled, len(self.order) - self.cursor)
            out[filled:filled + take] = \
                self.order[self.cursor:self.cursor + take]
            self.cursor += take
            filled += take
        return out


class ShardedStreamLoader:
    """Callback-placed shards -> per-device ``SampleBuffer`` prefetch ->
    masked training batches.  Implements the trainer's streamdata duck type
    (``time_aware``, ``on_arrivals``, ``batches``, ``label_divergence``)."""

    time_aware = True

    def __init__(self, data: ClassClusterData, n_devices: int,
                 shards: Sequence[np.ndarray],
                 placement: Callable[[int, int], int] = round_robin_placement,
                 policy: str = PERSISTENCE,
                 max_buffer: Optional[int] = None,
                 evict: str = DROP_OLDEST,
                 augment: bool = True, seed: int = 0):
        self.data = data
        self.n_devices = int(n_devices)
        self.augment = augment
        self.shard_owner = np.array(
            [int(placement(s, n_devices)) for s in range(len(shards))],
            np.int64)
        if not ((0 <= self.shard_owner) & (self.shard_owner < n_devices)).all():
            raise ValueError("placement callback returned a device outside "
                             f"[0, {n_devices})")
        pools: List[np.ndarray] = []
        for dev in range(n_devices):
            own = [shards[s] for s in np.flatnonzero(self.shard_owner == dev)]
            pools.append(np.concatenate(own) if own
                         else np.empty(0, np.int64))
        # placement defines a partition: reuse its stats (assigned-exactly-
        # once holds because shards are disjoint and each placed exactly once)
        num_classes = int(np.asarray(data.train_y).max()) + 1
        self.partition: Partition = _finish("placed", data.train_y, pools,
                                            num_classes)
        seqs = np.random.SeedSequence([seed, 0x10AD]).spawn(n_devices)
        self.devices = [DeviceStreamState(
            pool=self.partition.assignments[d],
            rng=np.random.default_rng(seqs[d]))
            for d in range(n_devices)]
        self.buffers = [SampleBuffer(policy=policy, max_size=max_buffer,
                                     evict=evict)
                        for _ in range(n_devices)]

    # -- streamdata hooks ------------------------------------------------
    def label_divergence(self) -> np.ndarray:
        return label_divergence(self.partition.class_probs,
                                self.partition.global_probs)

    def on_arrivals(self, arriving: np.ndarray) -> None:
        """Prefetch this round's arrivals into the per-device buffers.
        ``arriving`` is the trainer's (D,) float arrival vector; fractional
        remainders accumulate so long-run sample counts match the rates."""
        for dev, st in enumerate(self.devices):
            st.frac += float(arriving[dev])
            n = int(st.frac)
            st.frac -= n
            if n > 0:
                self.buffers[dev].extend(st.next_ids(n).tolist())

    def batches(self, rng: np.random.Generator, batch_sizes: np.ndarray,
                b_max: int, t_sim: float = 0.0):
        """Drain up to ``batch_sizes[dev]`` buffered ids per device into a
        fixed-shape masked batch.  Short buffers yield short batches — the
        mask is the ground truth for how many samples existed."""
        D = self.n_devices
        xs = np.zeros((D, b_max) + self.data.image_shape, np.float32)
        ys = np.zeros((D, b_max), np.int32)
        masks = np.zeros((D, b_max), np.float32)
        for dev in range(D):
            want = int(min(batch_sizes[dev], b_max))
            ids = np.asarray(self.buffers[dev].take(want), np.int64)
            n = len(ids)
            if n == 0:
                continue
            x = self.data.train_x[ids]
            if self.augment:
                augment_batch(rng, x)
            xs[dev, :n] = x
            ys[dev, :n] = self.data.train_y[ids]
            masks[dev, :n] = 1.0
        return xs, ys, masks

    # -- accounting ------------------------------------------------------
    def conservation(self) -> dict:
        """Per-fleet sample accounting; ``balanced`` must always be True."""
        streamed = sum(b.total_streamed for b in self.buffers)
        taken = sum(b.total_taken for b in self.buffers)
        dropped = sum(b.total_dropped for b in self.buffers)
        buffered = sum(len(b) for b in self.buffers)
        return {"streamed": streamed, "taken": taken, "dropped": dropped,
                "buffered": buffered,
                "balanced": streamed == taken + dropped + buffered}


def make_sharded_loader(data: ClassClusterData, n_devices: int,
                        shards_per_device: int = 4, skewed: bool = False,
                        **kw) -> ShardedStreamLoader:
    """Convenience: label-sharded dataset + round-robin (near-IID) or
    contiguous (pathological skew) placement."""
    n_shards = n_devices * max(int(shards_per_device), 1)
    shards = make_label_shards(data.train_y, n_shards)
    placement = contiguous_placement(n_shards) if skewed \
        else round_robin_placement
    return ShardedStreamLoader(data, n_devices, shards, placement=placement,
                               **kw)

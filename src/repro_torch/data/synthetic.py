"""Synthetic datasets: class-clustered images (CIFAR stand-in) + LM tokens.

Carried over from ``repro/data/synthetic.py`` with its numpy logic
unchanged, so equal seeds give identical data in both packages.

The paper streams CIFAR-10/100 frames; offline we generate a class-clustered
image dataset whose non-IID partitions genuinely hurt convergence (each class
is a distinct Gaussian cluster + structured noise), so data-injection effects
are measurable.  The LM dataset has planted bigram structure so perplexity
improves with training (used by the end-to-end transformer example).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ClassClusterData:
    """K-class Gaussian-cluster images, shape (32, 32, 3)."""
    num_classes: int = 10
    image_shape: Tuple[int, int, int] = (32, 32, 3)
    train_per_class: int = 512
    test_per_class: int = 64
    noise: float = 0.9
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        d = int(np.prod(self.image_shape))
        # class templates: smooth low-frequency patterns (distinguishable but
        # not trivially separable under noise)
        base = rng.normal(0, 1, size=(self.num_classes, 8, 8, 3))
        templates = np.stack([
            np.kron(base[c], np.ones((4, 4, 1))) for c in range(self.num_classes)
        ])  # (K, 32, 32, 3)
        self.templates = templates.astype(np.float32)

        def make(n):
            ys = np.repeat(np.arange(self.num_classes), n)
            xs = (self.templates[ys]
                  + rng.normal(0, self.noise, size=(len(ys),) + self.image_shape))
            return xs.astype(np.float32), ys.astype(np.int32)

        self.train_x, self.train_y = make(self.train_per_class)
        self.test_x, self.test_y = make(self.test_per_class)
        # per-class index lists for skewed sampling
        self.by_class = [np.where(self.train_y == c)[0]
                         for c in range(self.num_classes)]


def label_skew_partition(num_classes: int, n_devices: int,
                         labels_per_device: int) -> list:
    """Paper Table III: map label subsets to devices (non-IID).

    CIFAR10: 10 devices x 1 label; CIFAR100: 25 devices x 4 labels.
    """
    assert n_devices * labels_per_device >= num_classes
    out = []
    c = 0
    for _ in range(n_devices):
        out.append([(c + j) % num_classes for j in range(labels_per_device)])
        c = (c + labels_per_device) % num_classes
    return out


def augment_batch(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Streaming-style augmentation: random horizontal flip + crop-shift.

    Mutates ``x`` in place and consumes exactly two rng draws (a (n,) uniform
    and a (n, 2) integer draw) — the streamdata sources share this function so
    an IID streamdata-fed run replays ``DeviceDataSource``'s rng sequence
    bit-exactly.
    """
    n = len(x)
    flip = rng.random(n) < 0.5
    x[flip] = x[flip, :, ::-1]
    shift = rng.integers(-2, 3, size=(n, 2))
    for i in range(n):
        x[i] = np.roll(x[i], tuple(shift[i]), axis=(0, 1))
    return x


@dataclasses.dataclass
class DeviceDataSource:
    """Per-device sampler over ClassClusterData, IID or label-skewed."""
    data: ClassClusterData
    n_devices: int
    iid: bool = True
    labels_per_device: int = 1
    augment: bool = True      # random flip + crop-shift, mimicking streaming

    def __post_init__(self):
        if not self.iid:
            self.device_labels = label_skew_partition(
                self.data.num_classes, self.n_devices, self.labels_per_device)

    def _sample_device(self, rng, dev: int, n: int):
        if self.iid:
            idx = rng.integers(0, len(self.data.train_y), size=n)
        else:
            pools = np.concatenate(
                [self.data.by_class[c] for c in self.device_labels[dev]])
            idx = pools[rng.integers(0, len(pools), size=n)]
        x = self.data.train_x[idx]
        y = self.data.train_y[idx]
        if self.augment:
            augment_batch(rng, x)
        return x, y

    def batches(self, rng, batch_sizes: np.ndarray, b_max: int):
        """-> xs (D, b_max, ...), ys (D, b_max), masks (D, b_max)."""
        D = self.n_devices
        xs = np.zeros((D, b_max) + self.data.image_shape, np.float32)
        ys = np.zeros((D, b_max), np.int32)
        masks = np.zeros((D, b_max), np.float32)
        for dev in range(D):
            n = int(min(batch_sizes[dev], b_max))
            x, y = self._sample_device(rng, dev, n)
            xs[dev, :n], ys[dev, :n], masks[dev, :n] = x, y, 1.0
        return xs, ys, masks


@dataclasses.dataclass
class TokenData:
    """Synthetic LM stream with planted bigram transitions."""
    vocab_size: int = 1024
    seq_len: int = 128
    seed: int = 0
    determinism: float = 0.8   # prob. of following the planted bigram table

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.table = rng.integers(0, self.vocab_size, size=self.vocab_size)

    def sample(self, rng, batch: int, seq_len: Optional[int] = None):
        s = seq_len or self.seq_len
        toks = np.zeros((batch, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        for t in range(1, s + 1):
            follow = rng.random(batch) < self.determinism
            toks[:, t] = np.where(follow, self.table[toks[:, t - 1]],
                                  rng.integers(0, self.vocab_size, size=batch))
        return toks[:, :-1], toks[:, 1:]          # inputs, labels

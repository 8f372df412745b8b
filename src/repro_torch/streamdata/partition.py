"""Non-IID partitioners over labelled datasets + skew/divergence metrics.

The paper's second heterogeneity axis (§II, §V) is *statistical*: edge
devices see unbalanced, skewed slices of the global distribution.  A
``Partition`` assigns every training sample to exactly one device and keeps
the per-device empirical class mix, so everything downstream — streaming
sources, skew-corrected aggregation weights, controller telemetry — can ask
"how far is device i's data from the global mix?" without re-deriving it.

Three skew families (the federated-learning standards):

* ``dirichlet_partition`` — label skew via per-class Dirichlet(α) splits
  (Hsu et al.): α→∞ recovers IID, α→0 approaches one-class devices;
* ``shard_partition``     — pathological sort-by-label shards (McMahan et
  al.'s FedAvg construction): ``shards_per_device=1`` with K >= D gives
  each device a single class — the maximal-divergence corner;
* ``quantity_skew_partition`` — IID labels, Dirichlet(α)-skewed *counts*
  (some devices simply hold far more data).

Divergence metric: per-device total-variation distance to the global label
mix (the L1 form of the earth mover's distance on a categorical label space,
where all classes are equidistant):

    TV_i = 0.5 * sum_c | p_i(c) - p_global(c) |

0 for IID devices, ``(K-1)/K`` for a one-class device under a balanced
global mix (``max_divergence``).  ``label_entropy`` is the companion
coverage signal (bits of label diversity each device actually sees).

Carried over from ``repro/streamdata/partition.py`` with its numpy logic
unchanged, so equal seeds give identical assignments, class mixes and
divergences in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """A disjoint assignment of sample indices to devices.

    ``assignments[i]`` are the dataset indices device i owns; every index in
    ``[0, n_samples)`` appears in exactly one device's list.  ``class_probs``
    is the (D, K) per-device empirical label distribution and
    ``global_probs`` the (K,) dataset-wide mix.
    """
    kind: str
    assignments: List[np.ndarray]
    class_probs: np.ndarray      # (D, K)
    global_probs: np.ndarray     # (K,)
    alpha: Optional[float] = None

    @property
    def n_devices(self) -> int:
        return len(self.assignments)

    @property
    def num_classes(self) -> int:
        return int(self.class_probs.shape[1])

    def counts(self) -> np.ndarray:
        """Per-device sample counts (quantity-skew view)."""
        return np.array([len(a) for a in self.assignments], np.int64)

    def shares(self) -> np.ndarray:
        """Per-device fraction of the dataset (sums to 1)."""
        c = self.counts().astype(np.float64)
        return c / max(c.sum(), 1.0)

    def divergence(self) -> np.ndarray:
        """Per-device TV distance to the global label mix (see module doc)."""
        return label_divergence(self.class_probs, self.global_probs)

    def entropy(self) -> np.ndarray:
        """Per-device label entropy in bits."""
        return label_entropy(self.class_probs)


# ---------------------------------------------------------------------------
# metrics


def label_divergence(class_probs: np.ndarray,
                     global_probs: np.ndarray) -> np.ndarray:
    """Per-device total-variation distance (categorical EMD) to the global
    mix: ``0.5 * sum_c |p_i(c) - g(c)|``, one value per device in [0, 1)."""
    p = np.asarray(class_probs, np.float64)
    g = np.asarray(global_probs, np.float64)
    return 0.5 * np.abs(p - g[None, :]).sum(axis=1)


def label_entropy(class_probs: np.ndarray) -> np.ndarray:
    """Per-device label entropy in bits (0 for a one-class device)."""
    p = np.asarray(class_probs, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, -p * np.log2(p), 0.0)
    return terms.sum(axis=1)


def max_divergence(num_classes: int) -> float:
    """TV distance of a one-class device from a balanced K-class mix."""
    k = max(int(num_classes), 1)
    return (k - 1) / k


def label_coverage(divergence: np.ndarray, floor: float = 0.05) -> np.ndarray:
    """Map a divergence vector to aggregation-weight coverage factors in
    (0, 1]: 1 for an IID device, ``floor`` at maximal divergence.  The
    skew-corrected weighting mode multiplies rate weights by this."""
    cov = 1.0 - np.asarray(divergence, np.float64)
    return np.clip(cov, float(floor), 1.0)


def _stats(labels: np.ndarray, assignments: List[np.ndarray],
           num_classes: int):
    labels = np.asarray(labels)
    counts = np.zeros((len(assignments), num_classes), np.float64)
    for i, idx in enumerate(assignments):
        if len(idx):
            counts[i] = np.bincount(labels[idx], minlength=num_classes)
    probs = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
    global_counts = np.bincount(labels, minlength=num_classes)
    global_probs = global_counts / max(len(labels), 1)
    return probs, global_probs


def _rebalance_empty(assignments: List[np.ndarray]) -> List[np.ndarray]:
    """Give every device at least one sample by stealing from the richest
    device (deterministic: no rng draws — stable under retries)."""
    for i, idx in enumerate(assignments):
        if len(idx) == 0:
            donor = int(np.argmax([len(a) for a in assignments]))
            assignments[i] = assignments[donor][-1:]
            assignments[donor] = assignments[donor][:-1]
    return assignments


def _finish(kind: str, labels, assignments, num_classes, alpha=None):
    assignments = _rebalance_empty([np.asarray(a, np.int64)
                                    for a in assignments])
    probs, global_probs = _stats(labels, assignments, num_classes)
    return Partition(kind=kind, assignments=assignments, class_probs=probs,
                     global_probs=global_probs, alpha=alpha)


# ---------------------------------------------------------------------------
# partitioners


def iid_partition(labels: np.ndarray, n_devices: int,
                  rng: np.random.Generator) -> Partition:
    """Stratified IID split: each class is shuffled and dealt evenly across
    devices, so every device's empirical mix equals the global mix exactly
    (divergence identically 0 when class counts divide ``n_devices``) —
    a plain global shuffle would leave O(1/sqrt(n)) sampling-noise skew."""
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1 if len(labels) else 1
    assignments: List[List[int]] = [[] for _ in range(n_devices)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        idx = idx[rng.permutation(len(idx))]
        for dev, part in enumerate(np.array_split(idx, n_devices)):
            assignments[dev].extend(part.tolist())
    return _finish("iid", labels, assignments, num_classes)


def dirichlet_partition(labels: np.ndarray, n_devices: int, alpha: float,
                        rng: np.random.Generator) -> Partition:
    """Label skew: each class's samples split across devices by a
    Dirichlet(α) draw.  ``alpha=math.inf`` degenerates to the exact uniform
    split (the IID limit, without sampling noise)."""
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    assignments: List[List[int]] = [[] for _ in range(n_devices)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        idx = idx[rng.permutation(len(idx))]
        if math.isinf(alpha):
            p = np.full(n_devices, 1.0 / n_devices)
        else:
            p = rng.dirichlet(np.full(n_devices, float(alpha)))
        # proportional integer cut points over this class's shuffled pool
        cuts = np.floor(np.cumsum(p) * len(idx)).astype(int)[:-1]
        for dev, part in enumerate(np.split(idx, cuts)):
            assignments[dev].extend(part.tolist())
    return _finish("dirichlet", labels, assignments, num_classes,
                   alpha=float(alpha))


def shard_partition(labels: np.ndarray, n_devices: int,
                    shards_per_device: int,
                    rng: np.random.Generator) -> Partition:
    """Pathological skew: sort by label, cut into ``D * shards_per_device``
    contiguous shards, deal ``shards_per_device`` shards to each device in a
    random order.  Few shards per device => few classes per device."""
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    if shards_per_device < 1:
        raise ValueError(f"shards_per_device must be >= 1, "
                         f"got {shards_per_device}")
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_devices * shards_per_device)
    deal = rng.permutation(len(shards))
    assignments = [
        np.concatenate([shards[s]
                        for s in deal[i * shards_per_device:
                                      (i + 1) * shards_per_device]])
        for i in range(n_devices)]
    return _finish("shard", labels, assignments, num_classes)


def quantity_skew_partition(labels: np.ndarray, n_devices: int, alpha: float,
                            rng: np.random.Generator) -> Partition:
    """IID labels, skewed counts: a global shuffle cut by Dirichlet(α)
    shares — some devices simply hold far more data than others."""
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    perm = rng.permutation(len(labels))
    if math.isinf(alpha):
        shares = np.full(n_devices, 1.0 / n_devices)
    else:
        shares = rng.dirichlet(np.full(n_devices, float(alpha)))
    cuts = np.floor(np.cumsum(shares) * len(perm)).astype(int)[:-1]
    return _finish("quantity", labels, np.split(perm, cuts), num_classes,
                   alpha=float(alpha))


PARTITIONERS: dict = {
    "iid": iid_partition,
    "dirichlet": dirichlet_partition,
    "shard": shard_partition,
    "quantity": quantity_skew_partition,
}


def make_partition(labels: np.ndarray, n_devices: int, skew: str = "iid",
                   alpha: float = 1.0, shards_per_device: int = 1,
                   seed: int = 0,
                   rng: Optional[np.random.Generator] = None) -> Partition:
    """One-stop partitioner: ``skew`` picks the family, ``alpha`` the
    Dirichlet concentration (dirichlet/quantity), ``shards_per_device`` the
    shard deal.  Deterministic in (args, seed); pass ``rng`` to own the
    generator chain instead."""
    if rng is None:
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5EED]))
    if skew == "iid":
        return iid_partition(labels, n_devices, rng)
    if skew == "dirichlet":
        return dirichlet_partition(labels, n_devices, alpha, rng)
    if skew == "shard":
        return shard_partition(labels, n_devices, shards_per_device, rng)
    if skew == "quantity":
        return quantity_skew_partition(labels, n_devices, alpha, rng)
    raise ValueError(f"unknown skew family {skew!r}; "
                     f"options: {sorted(PARTITIONERS)}")

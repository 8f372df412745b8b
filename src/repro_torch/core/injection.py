"""Randomized data injection for non-IID streams (paper §IV).

Each iteration a random subset (fraction alpha) of the D devices shares a
fraction beta of its current streamed samples with the other devices, pulling
every device-local distribution toward the global one at a small, bounded
communication cost (Fig 9/10).

Carried over from ``repro/core/injection.py``, which imports JAX but
computes in numpy: the same logic, so equal seeds give identical plans and
batches in both packages.

Simulator form: batches are stacked (D, b, ...).  Receivers *replace* a beta
fraction of their own slots with samples drawn (round-robin) from the senders'
shared pool — batch size stays b_i, matching the paper's fixed per-iteration
compute, while the effective label mix becomes more representative.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def injection_plan(rng: np.random.Generator, n_devices: int, alpha: float,
                   beta: float, batch: int) -> Tuple[np.ndarray, int]:
    """-> (sender mask (D,), samples shared per sender)."""
    n_send = max(1, int(round(alpha * n_devices))) if alpha > 0 else 0
    senders = np.zeros(n_devices, dtype=bool)
    if n_send:
        senders[rng.choice(n_devices, size=n_send, replace=False)] = True
    n_share = int(round(beta * batch))
    return senders, n_share


def inject_batches(rng: np.random.Generator, data: np.ndarray,
                   labels: np.ndarray, senders: np.ndarray, n_share: int):
    """data (D, b, ...), labels (D, b). Returns injected copies + bytes moved.

    The first ``n_share`` slots of each sender's batch form the shared pool;
    every *other* device overwrites its last ``n_share`` slots with pool
    samples (cycled).  Senders keep their own batch unchanged.
    """
    D, b = labels.shape
    if n_share == 0 or not senders.any():
        return data, labels, 0
    pool_x = data[senders][:, :n_share].reshape(-1, *data.shape[2:])
    pool_y = labels[senders][:, :n_share].reshape(-1)
    data = data.copy()
    labels = labels.copy()
    n_pool = pool_y.shape[0]
    receivers = np.where(~senders)[0]
    for r in receivers:
        take = rng.integers(0, n_pool, size=n_share)
        data[r, b - n_share:] = pool_x[take]
        labels[r, b - n_share:] = pool_y[take]
    bytes_moved = pool_x.nbytes + pool_y.nbytes  # broadcast pool once
    return data, labels, bytes_moved


def injection_overhead_bytes(alpha: float, beta: float, n_devices: int,
                             batch: int, sample_bytes: int) -> float:
    """Per-iteration network overhead (Fig 10): senders broadcast their pool."""
    n_send = max(1, int(round(alpha * n_devices))) if alpha > 0 else 0
    return n_send * int(round(beta * batch)) * sample_bytes


def label_emd(labels: np.ndarray, num_classes: int) -> float:
    """Mean earth-mover's distance (total variation over discrete labels)
    between each device's label distribution and the global one — the paper's
    own skewness metric (via Zhao et al.).  labels (D, b)."""
    D = labels.shape[0]
    global_hist = np.bincount(labels.reshape(-1), minlength=num_classes)
    global_p = global_hist / max(global_hist.sum(), 1)
    emds = []
    for d in range(D):
        h = np.bincount(labels[d], minlength=num_classes)
        p = h / max(h.sum(), 1)
        emds.append(0.5 * np.abs(p - global_p).sum())
    return float(np.mean(emds))

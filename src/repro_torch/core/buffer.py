"""Stream buffers: Persistence vs Truncation policies (paper §IV, Eqn 2/3).

``CountingBuffer`` tracks queue sizes analytically (Fig 3b / Fig 8 / Table IV);
``SampleBuffer`` holds actual sample indices for the training loop.  Both share
policy semantics:

* persistence — every streamed sample is retained until consumed:
      Q_i(T) = (t_i * S_i - b_i) * T + S_i          (Eqn 2, grows O(S T))
* truncation  — after each iteration only the newest ~S_i samples survive:
      Q_i(T) = S_i                                   (O(S))

Carried over from ``repro/core/buffer.py`` with its numpy logic unchanged.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np

PERSISTENCE = "persistence"
TRUNCATION = "truncation"

# explicit overflow eviction for capacity-bounded SampleBuffers (paper §IV
# drops the *oldest* samples when an edge device's memory fills: the stream
# is freshest-first, so stale frames are the ones sacrificed)
DROP_OLDEST = "drop-oldest"
DROP_NEWEST = "drop-newest"


def queue_size_eqn2(t_iter: float, rate: float, batch: float, T: int) -> float:
    """Accumulated samples after T steps (Eqn 2), valid for t*S >= b."""
    return max(0.0, (t_iter * rate - batch)) * T + rate


def queue_size_eqn3(t_iter: float, rate: float, T: int) -> float:
    """High-rate limit (Eqn 3): Q = T t S + S when t*S >> b."""
    return T * t_iter * rate + rate


@dataclasses.dataclass
class CountingBuffer:
    policy: str = PERSISTENCE
    size: float = 0.0
    peak: float = 0.0
    total_streamed: float = 0.0
    total_dropped: float = 0.0
    total_consumed: float = 0.0

    def step(self, streamed: float, consumed: float) -> float:
        """One iteration: ``streamed`` samples arrive, ``consumed`` trained on."""
        self.total_streamed += streamed
        consumed = min(consumed, self.size + streamed)
        self.total_consumed += consumed
        self.size = self.size + streamed - consumed
        if self.policy == TRUNCATION and self.size > streamed:
            self.total_dropped += self.size - streamed
            self.size = streamed
        self.peak = max(self.peak, self.size)
        return self.size

    def refund(self, n: float) -> None:
        """Return ``n`` samples debited for work that was thrown away (a
        crashed device or a straggler cancelled by the sync policy): the
        samples were never trained on, so they go back on the queue.  Under
        truncation the next ``step`` re-applies the size cap."""
        self.total_consumed -= n
        self.size += n
        self.peak = max(self.peak, self.size)

    def clear(self) -> None:
        """Device crash/restart: queued samples are lost (counted as drops)."""
        self.total_dropped += self.size
        self.size = 0.0


class SampleBuffer:
    """FIFO of sample ids (ints into the device-local stream ordering).

    ``max_size`` bounds the queue (edge-device memory); overflow eviction is
    explicit: ``drop-oldest`` (paper §IV — stale frames are sacrificed for
    fresh ones) pops from the head, ``drop-newest`` refuses arrivals once
    full.  Conservation holds by construction:

        total_streamed == len(buffer) + total_taken + total_dropped
    """

    def __init__(self, policy: str = PERSISTENCE,
                 max_size: Optional[int] = None, evict: str = DROP_OLDEST):
        if evict not in (DROP_OLDEST, DROP_NEWEST):
            raise ValueError(f"unknown eviction policy {evict!r}; options: "
                             f"{[DROP_OLDEST, DROP_NEWEST]}")
        if max_size is not None and max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        self.policy = policy
        self.max_size = max_size
        self.evict = evict
        self._q: Deque[int] = collections.deque()
        self._next_id = 0
        self.peak = 0
        self.total_streamed = 0
        self.total_taken = 0
        self.total_dropped = 0

    def _append(self, sample_id: int) -> None:
        """One arrival under the capacity/eviction policy."""
        self.total_streamed += 1
        if self.max_size is not None and len(self._q) >= self.max_size:
            if self.evict == DROP_NEWEST:
                self.total_dropped += 1        # arrival refused, never queued
                return
            self._q.popleft()                  # drop-oldest: evict the head
            self.total_dropped += 1
        self._q.append(sample_id)

    def extend(self, ids: List[int]) -> None:
        """Stream specific sample ids in (the sharded loader's entry point:
        ids index the device's placed shards, not a synthetic counter)."""
        for sid in ids:
            self._append(int(sid))
        self.peak = max(self.peak, len(self._q))

    def stream_in(self, n: int) -> None:
        for _ in range(int(n)):
            self._append(self._next_id)
            self._next_id += 1
        if self.policy == TRUNCATION and len(self._q) > n:
            drop = len(self._q) - int(n)
            for _ in range(drop):
                self._q.popleft()
            self.total_dropped += drop
        self.peak = max(self.peak, len(self._q))

    def take(self, n: int) -> List[int]:
        out = []
        for _ in range(min(int(n), len(self._q))):
            out.append(self._q.popleft())
        self.total_taken += len(out)
        return out

    def clear(self) -> None:
        """Device crash/restart: queued samples are lost (counted as drops)."""
        self.total_dropped += len(self._q)
        self._q.clear()

    def __len__(self) -> int:
        return len(self._q)


def simulate_queue_growth(t_iter: float, rate: float, batch: float, steps: int,
                          policy: str = PERSISTENCE) -> np.ndarray:
    """Queue-size trajectory; one 'timestep' = one training iteration, during
    which ``t_iter * rate`` samples arrive (plus the initial burst S)."""
    buf = CountingBuffer(policy=policy)
    buf.step(rate, 0.0)          # ts=0 burst
    sizes = []
    for _ in range(steps):
        sizes.append(buf.step(t_iter * rate, min(batch, buf.size + t_iter * rate)))
    return np.asarray(sizes)

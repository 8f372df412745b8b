"""Discrete-event core shared by the fleet engine and the serving runtime.

Carried over from ``repro/sim/core.py`` unchanged.  Two consumers share
it: the fleet engine (``fleet/engine.py``) schedules per-device training
events, and ``serve`` schedules per-request serving events (arrival /
deadline), letting a batching scheduler interleave prefill and decode steps.

Both need the same two guarantees, which live here and nowhere else:

* **Total, deterministic order** — the queue is a min-heap on
  ``(time, seq)`` where ``seq`` is insertion order, so simultaneous events
  pop FIFO and runs are reproducible for a fixed seed (the reference's
  homogeneous full-sync fleet reproduces its legacy ``EdgeClock``
  bit-exactly because of this tie-break).
* **Monotone time** — ``SimClock`` only moves forward; an attempt to
  commit an event before the current time is a scheduling bug, not a
  rounding artifact, and raises immediately.

Event kinds are plain strings owned by the consumer (the fleet's live in
``fleet/events.py``, serving's in ``serve/engine.py``); the core is
kind-agnostic.  ``Event.actor`` identifies whose event it is — a device
index for the fleet, a request id for serving.  ``Event.device`` remains as
an alias so fleet-era call sites keep reading naturally.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Iterator, List, Optional


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    time: float
    seq: int = dataclasses.field(compare=True)   # FIFO tie-break
    kind: str = dataclasses.field(compare=False)
    actor: int = dataclasses.field(compare=False)

    @property
    def device(self) -> int:
        """Fleet-era alias: the actor of a training event is a device."""
        return self.actor


class EventQueue:
    """Min-heap of events keyed on (time, insertion order)."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str, actor: int) -> Event:
        ev = Event(time=float(time), seq=next(self._seq), kind=kind,
                   actor=actor)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield heapq.heappop(self._heap)


class SimClock:
    """Monotone simulation clock.

    ``advance_to`` tolerates sub-nanosecond backwards jitter (float noise
    from summing event chains) but treats anything larger as a scheduling
    bug: an engine that commits a round before its own current time has
    mis-ordered events, and silently clamping would hide it.
    """

    _EPS = 1e-9

    def __init__(self, t0: float = 0.0) -> None:
        self._now = float(t0)

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> float:
        t = float(t)
        if t < self._now - self._EPS:
            raise ValueError(
                f"clock moved backwards: {self._now} -> {t}")
        self._now = max(self._now, t)
        return self._now

    def advance_by(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"negative time delta: {dt}")
        self._now += float(dt)
        return self._now

"""Serving metrics: TTFT / TPOT percentiles, throughput and goodput.

Carried over from ``repro/serve/metrics.py`` unchanged: equal records give
identical summaries in both packages.

* **TTFT** — first-token latency: sim seconds from arrival to the first
  generated token (includes queueing + prefill; the batching discipline's
  fingerprint).
* **TPOT** — time per output token after the first (decode cadence).
* **throughput** — all generated tokens per second, deadline-blind.
* **goodput** — tokens of requests that *completed within their deadline*
  per second: tokens burned on a request that was evicted, or that finished
  late, count for nothing.  This is the serving analogue of the trainer's
  effective-samples metric, and the headline number of
  ``benchmarks/serving.py``.
* **queue wait** — arrival to admission (prefill start): the pure
  time-in-queue component of TTFT, so scheduler comparisons separate
  "waited for a slot" from "prefill was slow".

:class:`RollingWindow` folds terminal request events into a sliding
deadline-met-goodput estimate — the online objective the serve controller
climbs on (``serve/control.py``), mirroring the fleet engine's rolling
round telemetry.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle timestamps (sim seconds)."""
    rid: int
    arrival_s: float
    deadline_s: float
    target_tokens: int
    slo_ttft_s: float = float("inf")
    admit_s: Optional[float] = None       # prefill started
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None      # all target tokens generated
    tokens_out: int = 0
    dropped: Optional[str] = None         # "expired_in_queue" | "slo_miss"

    @property
    def completed(self) -> bool:
        return self.finish_s is not None and self.dropped is None

    @property
    def met_deadline(self) -> bool:
        """Both SLO clauses: first token in budget, completion by deadline."""
        return (self.completed
                and self.first_token_s - self.arrival_s
                <= self.slo_ttft_s + 1e-12
                and self.finish_s <= self.deadline_s + 1e-12)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        if self.finish_s is None or self.first_token_s is None \
                or self.tokens_out < 2:
            return None
        return (self.finish_s - self.first_token_s) / (self.tokens_out - 1)

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Arrival to admission — time-in-queue, excluding prefill."""
        if self.admit_s is None:
            return None
        return self.admit_s - self.arrival_s


def _pct(vals: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals), q)) if vals else float("nan")


def request_records(records: List[RequestRecord]) -> List[Dict]:
    """Per-request latency records: the raw material behind the percentiles,
    serialisable onto a run ledger (``benchmarks/serving.py`` emits these so
    tail behaviour can be audited without rerunning the sweep)."""
    return [{
        "rid": r.rid,
        "arrival_s": r.arrival_s,
        "admit_s": r.admit_s,
        "queue_wait_s": r.queue_wait_s,
        "ttft_s": r.ttft_s,
        "tpot_s": r.tpot_s,
        "finish_s": r.finish_s,
        "tokens_out": r.tokens_out,
        "dropped": r.dropped,
        "met_deadline": r.met_deadline,
    } for r in records]


def summarize(records: List[RequestRecord], horizon_s: float) -> Dict:
    """Fold request records into the scheduler-facing scorecard."""
    n = len(records)
    ttft = [r.ttft_s for r in records if r.ttft_s is not None]
    tpot = [r.tpot_s for r in records if r.tpot_s is not None]
    qwait = [r.queue_wait_s for r in records if r.queue_wait_s is not None]
    good_tokens = sum(r.tokens_out for r in records if r.met_deadline)
    all_tokens = sum(r.tokens_out for r in records)
    completed = sum(r.completed for r in records)
    met = sum(r.met_deadline for r in records)
    horizon = max(horizon_s, 1e-9)
    return {
        "n_requests": n,
        "completed": completed,
        "deadline_met": met,
        "dropped": sum(r.dropped is not None for r in records),
        "slo_attainment": met / n if n else float("nan"),
        "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
        "ttft_p99_s": _pct(ttft, 99),
        "tpot_p50_s": _pct(tpot, 50), "tpot_p95_s": _pct(tpot, 95),
        "tpot_p99_s": _pct(tpot, 99),
        "queue_wait_p50_s": _pct(qwait, 50),
        "queue_wait_p95_s": _pct(qwait, 95),
        "throughput_tok_s": all_tokens / horizon,
        "goodput_tok_s": good_tokens / horizon,
    }


class RollingWindow:
    """Sliding deadline-met-goodput estimator over terminal request events.

    The scheduler calls :meth:`record` once per request at its terminal
    event (finish / evict / drop) with the tokens that counted toward
    goodput (``tokens_out`` if the request met its SLO, else 0).
    :meth:`goodput` divides the surviving window total by the window span —
    a noisy-but-fresh objective an online controller can climb on without
    waiting for end-of-run ``summarize``.
    """

    def __init__(self, window_s: float):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = float(window_s)
        self._events: Deque[Tuple[float, int]] = deque()

    def _trim(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window_s:
            self._events.popleft()

    def record(self, t: float, good_tokens: int) -> None:
        # lanes complete actions at interleaved future times, so terminal
        # events arrive nearly-but-not-exactly ordered; clamp into order
        if self._events and t < self._events[-1][0]:
            t = self._events[-1][0]
        self._events.append((t, int(good_tokens)))
        self._trim(t)

    def n_events(self, now: float) -> int:
        self._trim(now)
        return len(self._events)

    def goodput(self, now: float) -> float:
        """Deadline-met tokens/s over the trailing window."""
        self._trim(now)
        return sum(g for _, g in self._events) / self.window_s

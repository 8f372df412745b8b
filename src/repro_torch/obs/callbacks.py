"""Producer-side hooks: turn serving state into tracker records.

The serving part of ``repro/obs/callbacks.py``, carried over unchanged.
The reference's ``RoundObserver`` and its MFU code count flops with the HLO
walker and wait for the port's observability slice.

Record kinds:

* ``serve_event``  — request lifecycle: admit / finish / evict / drop
  (``ContinuousBatchingServer``, ``Scheduler``).
* ``serve_summary`` — the scheduler scorecard (TTFT/TPOT/goodput).

Producers gate all metric assembly on ``tracker.active``, so a tracked run
makes the same decisions as an untracked one and ``NOOP`` costs nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.tracker import Tracker

SERVE_EVENT = "serve_event"
SERVE_SUMMARY = "serve_summary"


def serve_event(tracker: Tracker, event: str, *, rid: int, t: float,
                slot: Optional[int] = None,
                **extra: Any) -> None:
    """One request-lifecycle event on the serve ledger (admit, first_token,
    finish, evict, drop).  Callers gate on ``tracker.active``."""
    rec: Dict[str, Any] = {"event": event, "rid": int(rid), "t_s": float(t)}
    if slot is not None:
        rec["slot"] = int(slot)
    rec.update(extra)
    tracker.log_metrics(rec, kind=SERVE_EVENT)

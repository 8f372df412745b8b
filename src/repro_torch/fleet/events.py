"""Fleet event kinds on the shared discrete-event core (``repro_torch.sim``).

The queue and event primitives live in ``repro_torch.sim.core`` so the
serving runtime can schedule requests on the same deterministic heap; this
module keeps the *fleet vocabulary* — what a training event means:

* ``STREAM_READY``  — device gathered enough streamed samples to start
  (conventional DDL's per-device streaming wait; 0 for ScaDLES);
* ``COMPUTE_DONE``  — device finished its local gradient;
* ``COMM_DONE``     — device's gradient finished crossing its link;
* ``DEVICE_DOWN`` — a churn-model failure landing before a device's next
  stage completes, killing its in-flight work (re-admission is scheduled
  from the churn process's recovery time, not via the queue).

The legacy ``EdgeClock`` advances one lockstep iteration at a time; the fleet
engine instead schedules *per-device* events on a priority queue and lets the
sync policy decide when — and at what granularity — a round commits: one
fleet-wide barrier (full-sync/backup-workers), a quorum (bounded-staleness),
the first K arrivals (semi-sync), or every single arrival (async).  No new
event kinds are needed for the relaxed modes: a COMM_DONE the policy does not
commit simply stays in flight (``busy_until``) and re-enters a later round's
queue.

Ordering is total: ties in time break by insertion order (FIFO), so runs are
deterministic for a fixed seed — that guarantee now lives in
``repro_torch.sim.core.EventQueue`` and is shared with ``repro_torch.serve``.
"""
from __future__ import annotations

from repro_torch.sim.core import Event, EventQueue  # noqa: F401

STREAM_READY = "stream_ready"
COMPUTE_DONE = "compute_done"
COMM_DONE = "comm_done"
DEVICE_DOWN = "device_down"

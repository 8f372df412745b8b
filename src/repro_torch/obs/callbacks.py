"""Producer-side hooks: turn subsystem state into tracker records.

Carried over from ``repro/obs/callbacks.py``.  The trainer, fleet engine and
serving scheduler hold a tracker and, when it is active, hand their
already-computed host-side state to the helpers here.  Everything derived
(MFU, wire bytes, samples/s) is computed *from* that state:

* no extra work on the card, ever (flops are counted once per step function
  on ``meta`` copies of its arguments, ``obs/mfu.py``);
* no metric assembly when ``tracker.active`` is False;
* nothing written back into trainer state: hooks are read-only observers.

Record kinds (one namespace per producer, shared ledger):

* ``train_round``  — per-commit trainer record: loss, MFU, samples/s, wire
  bytes, staleness/buffer stats (``ScaDLESTrainer``).
* ``train_summary`` — end-of-run ``trainer.summary()``.
* ``fleet_round``  — per-commit engine telemetry (``FleetEngine.round``).
* ``serve_event``  — request lifecycle: admit / finish / evict / drop
  (``ContinuousBatchingServer``, ``Scheduler``).
* ``serve_summary`` — the scheduler scorecard (TTFT/TPOT/goodput).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from repro_torch.obs.mfu import DEVICE_PEAK_FLOPS, counted_flops, mfu
from repro_torch.obs.tracker import NOOP, Tracker

TRAIN_ROUND = "train_round"
TRAIN_SUMMARY = "train_summary"
FLEET_ROUND = "fleet_round"
SERVE_EVENT = "serve_event"
SERVE_SUMMARY = "serve_summary"


def ring_wire_bytes_per_device(n_devices: int, floats_on_wire: float) -> float:
    """Analytic per-device ring-allreduce bytes (the EdgeClock formula)."""
    n = max(int(n_devices), 1)
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * 4.0 * float(floats_on_wire)


class RoundObserver:
    """Per-round observability for ``ScaDLESTrainer``.

    Owns the flops cache: the first tracked round counts the model flops of
    the step function it actually ran (plain or carry path: they do
    different work) with ``counted_flops`` on meta copies of its arguments;
    later rounds reuse the count.  An inactive tracker means ``on_round`` is
    never called, so construction is free and nothing is ever counted.
    """

    def __init__(self, tracker: Tracker, *, n_devices: int,
                 peak_flops: float = DEVICE_PEAK_FLOPS) -> None:
        self.tracker = tracker if tracker is not None else NOOP
        self.n_devices = int(n_devices)
        self.peak_flops = float(peak_flops)
        self._flops_cache: Dict[int, Optional[float]] = {}

    @property
    def active(self) -> bool:
        return self.tracker.active

    def step_flops(self, step_fn, step_args) -> Optional[float]:
        """Model flops of one call of ``step_fn`` (cached per function)."""
        if step_fn is None:
            return None
        key = id(step_fn)
        if key not in self._flops_cache:
            self._flops_cache[key] = counted_flops(step_fn, *step_args)
        return self._flops_cache[key]

    def wire_bytes_per_device(self, floats_on_wire: float,
                              comm_model: Optional[Any] = None) -> float:
        """Per-device gradient wire bytes this round: from the comm model when
        one is attached (``repro_torch.dist.calibrate``), analytic ring
        formula otherwise — the same source the sim clock charges."""
        if comm_model is not None:
            return float(comm_model.bytes_for(floats_on_wire))
        return ring_wire_bytes_per_device(self.n_devices, floats_on_wire)

    def on_round(self, *, step: int, rec: Mapping, dt: float,
                 step_fn=None, step_args=None, n_part: float,
                 floats_on_wire: float, inj_bytes: float = 0.0,
                 comm_model: Optional[Any] = None) -> None:
        """Emit one ``train_round`` record.  ``rec`` is the trainer's own
        history record (already computed); everything else is derived here.
        ``step_fn=None`` marks an empty commit (no update ran)."""
        flops = self.step_flops(step_fn, step_args)
        per_dev = self.wire_bytes_per_device(floats_on_wire, comm_model)
        samples = float(rec.get("global_batch", 0.0))
        out = dict(rec)
        out.update({
            "dt_s": float(dt),
            "step_flops": flops,
            "mfu": mfu(flops, dt, n_devices=self.n_devices,
                       peak_flops=self.peak_flops),
            "samples_per_s": samples / dt if dt > 0 else 0.0,
            "wire_bytes_device": per_dev,
            "wire_bytes_round": per_dev * float(n_part) + float(inj_bytes),
        })
        self.tracker.log_metrics(out, step=step, kind=TRAIN_ROUND)

    def on_run_end(self, summary: Mapping) -> None:
        self.tracker.log_summary(summary, kind=TRAIN_SUMMARY)


def fleet_round_record(tel) -> Dict[str, float]:
    """Flatten a ``RoundTelemetry`` into a ledger-friendly record."""
    return {
        "policy": tel.policy,
        "dt_s": tel.dt,
        "commit_time_s": tel.commit_time,
        "n_started": tel.n_started,
        "n_participants": tel.n_participants,
        "n_carried": tel.n_carried,
        "n_dropped": tel.n_dropped,
        "n_crashed": tel.n_crashed,
        "committed_samples": tel.committed_samples,
        "committed_wait_s": tel.committed_wait,
        "mean_staleness": tel.mean_staleness,
        "max_staleness": tel.max_staleness,
        "label_divergence": getattr(tel, "label_divergence", 0.0),
        **{f"knob_{k}": float(v) for k, v in tel.knobs.items()},
    }


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

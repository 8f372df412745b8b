"""Discrete-event fleet engine: per-device scheduling under a sync policy.

One engine ``round()`` replaces one legacy ``EdgeClock.step()``.  Instead of a
single lockstep ``wait + compute + comm`` sum, each device runs its own event
chain on a shared queue —

    STREAM_READY(T0 + wait_i)
      -> COMPUTE_DONE(+ compute_sec * b_i / ref * mult_i)
      -> COMM_DONE(+ ring_bytes / (bw_i * efficiency))

— interleaved with DEVICE_DOWN transitions from the churn model, which kill
in-flight work (crash).  The sync policy then picks the commit time and the
participant set from the realised completion times.

Commit granularity is the policy's call: full-sync/backup-workers commit one
barrier per round; bounded-staleness, semi-sync (first K arrivals), and async
(every arrival) commit sub-barrier groups, carrying the rest in flight.  The
engine tracks a per-device *model version* — ``read_version[i]`` is the
global version (= commits so far) device i's in-flight work started from —
and each ``RoundResult`` reports the per-commit gradient staleness
``version - read_version`` so the trainer can aggregate stale gradients at
the parameters the device actually read, with staleness-aware damping.

Degenerate case: a homogeneous fleet (``k80-uniform``) under ``full-sync``
with churn off makes every completion identical to the legacy lockstep sum,
so sim-times reproduce ``EdgeClock`` exactly (tested to 1e-9, required to 1%).

Compute-charging models (``FleetConfig.compute_model``):

* ``lockstep``   — every device is charged the fleet-mean batch, matching the
  legacy clock's calibrated aggregate model (default for homogeneous fleets);
* ``per-device`` — each device is charged its own rate-proportional batch
  (default for heterogeneous fleets, where batch skew is part of the story).

Communication is modelled per link: a device's ring-allreduce share
(2(N-1)/N * 4G bytes, plus any injection broadcast) crosses its own link at
``bandwidth_gbps * bandwidth_efficiency`` — under heterogeneous links the
round becomes slowest-link-bound, which is how a ring actually degrades.
``FleetConfig.comm_model`` (e.g. ``repro_torch.dist.calibrate.CommCalibration``,
recorded from the DDP programs) replaces the analytic byte count with measured
per-device collective wire bytes; ``None`` keeps the legacy formula and the
bit-exact EdgeClock equivalence.

Control plane: the engine is *reconfigurable while running*.  ``set_policy``
/ ``reconfigure`` queue a policy swap or a knob change that is honoured only
at the next round boundary — the round in progress (and its planning) always
runs under the policy that started it, mirroring the trainer's
compression-replay rule for in-flight work.  Every round appends a
``RoundTelemetry`` record to a rolling window (``telemetry``), and
``telemetry_summary()`` folds the window into the rates a controller needs:
commit rate, effective samples/sec, committed-wait fraction, staleness
distribution.  ``FleetConfig.controller`` attaches a ``repro_torch.fleet.control``
controller; the trainer feeds it the realised loss via ``controller_update``
and its actions flow back through the same deferred-reconfiguration path.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.simclock import EdgeClockConfig, effective_bandwidth_Bps
from repro_torch.fleet import events as ev
from repro_torch.fleet.devices import (LOCKSTEP, DeviceProfile, FleetConfig,
                                 link_gbps)
from repro_torch.fleet.policies import ChurnProcess, SyncPolicy, make_policy
from repro_torch.obs.callbacks import FLEET_ROUND, fleet_round_record
from repro_torch.obs.tracker import NOOP
from repro_torch.sim import SimClock

_MAX_IDLE_RETRIES = 1000


@dataclasses.dataclass(frozen=True)
class RoundTelemetry:
    """One commit's worth of control-plane signals (rolling-window entry)."""
    round_index: int
    policy: str                # policy family that planned this commit
    knobs: Dict[str, float]    # its knob values at plan time
    dt: float                  # sim seconds the round took
    commit_time: float         # absolute commit time
    n_started: int
    n_participants: int
    n_carried: int
    n_dropped: int
    n_crashed: int
    committed_samples: float   # stream samples in the committed gradients
    committed_wait: float      # realised max wait among committed starters
    mean_staleness: float      # over this commit's participants
    max_staleness: int
    label_divergence: float = 0.0   # mean TV-to-global-mix over participants
    #                                 (0.0 when the data plane reports none)


@dataclasses.dataclass
class RoundResult:
    dt: float                 # sim seconds this round took
    commit_time: float        # absolute sim time of the aggregation commit
    started: np.ndarray       # bool (D,): began fresh work this round
    part: np.ndarray          # bool (D,): gradient aggregated at the commit
    online_frac: np.ndarray   # float (D,): uptime fraction over the round
    max_wait: float           # realised wait among committed fresh starters
    crashed: List[int]        # lost in-flight work to a mid-round failure
    dropped: List[int]        # stragglers cancelled by the policy
    carried: List[int]        # work still in flight past the commit
    interrupted: List[int]    # any downtime during the round (buffer policy)
    staleness: np.ndarray     # int (D,): commits each participant's gradient
    #                           is behind the model it read (-1 = not committing)
    version: int = 0          # model version after this commit


class FleetEngine:
    """Event-queue clock for a heterogeneous fleet; one round per train step."""

    def __init__(self, cfg: FleetConfig, base: EdgeClockConfig,
                 tracker=None):
        self.cfg = cfg
        self.base = base
        # observability sink (repro_torch.obs): every commit's RoundTelemetry is
        # mirrored onto the ledger as a ``fleet_round`` record.  Strictly a
        # read-only mirror of state the engine computes anyway — attaching a
        # tracker cannot change a single event time (zero-perturbation).
        self.tracker = tracker if tracker is not None else NOOP
        self.n = base.n_devices
        self.profiles: List[DeviceProfile] = cfg.resolve_profiles(self.n)
        self.compute_model = cfg.resolve_compute_model(self.profiles)
        self.comm_model = cfg.comm_model
        cal_n = getattr(self.comm_model, "n_devices", None)
        if cal_n is not None and cal_n != self.n:
            raise ValueError(
                f"comm_model calibrated for {cal_n} devices but the fleet "
                f"has {self.n}; recalibrate the comm model for this "
                "device count — ring wire bytes do not transfer across D")
        self.policy: SyncPolicy = make_policy(cfg)
        self.churn = ChurnProcess(self.profiles, seed=cfg.seed,
                                  enabled=cfg.churn)
        # control plane: queued policy/knob changes (applied at the next
        # round boundary), rolling telemetry window, optional controller
        self._pending_policy: Optional[SyncPolicy] = None
        self._pending_knobs: Dict[str, float] = {}
        self.telemetry: Deque[RoundTelemetry] = deque(
            maxlen=max(int(cfg.telemetry_window), 1))
        self.controller = None
        if cfg.controller is not None:
            from repro_torch.fleet.control import make_controller
            self.controller = make_controller(cfg, self.n)
            start = self.controller.start_policy(cfg, self.n)
            if start is not None:
                self.policy = start
        self.policy_switches = 0
        self._work_batch = np.zeros(self.n)      # batch behind in-flight work
        self._clock = SimClock()                 # shared sim core (repro_torch.sim)
        self.busy_until: Dict[int, float] = {}   # in-flight comm-done times
        self.staleness = np.zeros(self.n, np.int64)
        # per-device model versions: ``version`` counts commits so far and
        # ``read_version[i]`` is the version device i's in-flight (or last)
        # work started from — a commit's gradient staleness is the difference
        self.version = 0
        self.read_version = np.zeros(self.n, np.int64)
        # lifetime counters for summaries
        self.rounds = 0
        self.total_participants = 0
        self.total_dropped = 0
        self.total_crashed = 0
        self.total_staleness = 0
        self.max_staleness = 0
        self.idle_advances = 0

    @property
    def time_s(self) -> float:
        """Current sim time (monotone; advanced only at round commits)."""
        return self._clock.now

    # -- per-device timing ------------------------------------------------
    def device_compute_time(self, i: int, batch: float,
                            mean_batch: float) -> float:
        b = mean_batch if self.compute_model == LOCKSTEP else batch
        return (self.base.compute_sec_per_iter * max(b, 1.0)
                / self.base.reference_batch * self.profiles[i].compute_mult)

    def device_comm_time(self, i: int, floats_on_wire: float,
                         extra_bytes: float = 0.0) -> float:
        if self.comm_model is not None:
            # calibrated source: per-device collective wire bytes recorded
            # from the DDP program (repro_torch.dist.calibrate)
            bytes_ = self.comm_model.bytes_for(floats_on_wire) + extra_bytes
        else:
            ring = 2 * (self.n - 1) / self.n
            bytes_ = ring * 4.0 * floats_on_wire + extra_bytes
        eff_bw = effective_bandwidth_Bps(
            link_gbps(self.profiles[i], self.base.bandwidth_gbps),
            self.base.bandwidth_efficiency)
        return bytes_ / eff_bw

    # -- control plane ----------------------------------------------------
    def set_policy(self, policy: Union[str, SyncPolicy], **knobs) -> None:
        """Queue a policy-family switch (by name, using the config's knob
        defaults, or a ready-made instance).  Honoured at the next round
        boundary: the in-progress round commits under the policy that
        started it.  ``knobs`` reconfigure the incoming policy."""
        new = (make_policy(self.cfg, name=policy)
               if isinstance(policy, str) else policy)
        # knob changes already queued via reconfigure() carry over where the
        # incoming family understands them (explicit knobs in this call win)
        # rather than being silently dropped
        carried = {k: v for k, v in self._pending_knobs.items()
                   if k in new.KNOBS and k not in knobs}
        if carried:
            new.reconfigure(**carried)
        if knobs:
            new.reconfigure(**knobs)
        self._pending_policy = new
        self._pending_knobs = {}

    def reconfigure(self, **knobs) -> None:
        """Queue knob changes on the current policy (names *and values*
        validated now, applied at the next round boundary)."""
        target = self._pending_policy if self._pending_policy is not None \
            else self.policy
        knobs = target.validate_knobs(**knobs)
        if self._pending_policy is not None:
            self._pending_policy.reconfigure(**knobs)
        else:
            self._pending_knobs.update(knobs)

    def _apply_pending(self) -> None:
        if self._pending_policy is not None:
            if self._pending_policy.name != self.policy.name or \
                    self._pending_policy.knobs() != self.policy.knobs():
                self.policy_switches += 1
            self.policy = self._pending_policy
            self._pending_policy = None
        if self._pending_knobs:
            pending, self._pending_knobs = self._pending_knobs, {}
            if pending != {k: self.policy.knobs().get(k) for k in pending}:
                self.policy_switches += 1
            self.policy.reconfigure(**pending)

    def controller_update(self, loss: float):
        """Feed the trainer's realised loss for the latest commit to the
        attached controller; apply any action it emits through the deferred
        reconfiguration path.  Returns the action (or None)."""
        if self.controller is None or not self.telemetry:
            return None
        action = self.controller.update(self.telemetry[-1], float(loss))
        if action is not None:
            if action.policy is not None:
                self.set_policy(action.policy, **action.knobs)
            elif action.knobs:
                self.reconfigure(**action.knobs)
        return action

    def telemetry_summary(self) -> Dict[str, float]:
        """Fold the rolling window into controller-facing rates."""
        win = list(self.telemetry)
        if not win:
            return {}
        dt = sum(t.dt for t in win)
        n_part = sum(t.n_participants for t in win)
        stale = [t.mean_staleness for t in win if t.n_participants]
        return {
            "window_rounds": float(len(win)),
            "window_sim_s": dt,
            "commit_rate": len(win) / max(dt, 1e-12),
            "eff_samples_per_s": (sum(t.committed_samples for t in win)
                                  / max(dt, 1e-12)),
            "gradients_per_s": n_part / max(dt, 1e-12),
            "committed_wait_frac": (sum(t.committed_wait for t in win)
                                    / max(dt, 1e-12)),
            "mean_staleness": float(np.mean(stale)) if stale else 0.0,
            "max_staleness": float(max(t.max_staleness for t in win)),
            "mean_label_divergence": (
                float(np.mean([t.label_divergence for t in win
                               if t.n_participants]))
                if any(t.n_participants for t in win) else 0.0),
        }

    def next_policy(self) -> SyncPolicy:
        """The policy the *next* round will run under — pending switch AND
        pending knob changes included — what the trainer must size its
        commit machinery for.  With queued knobs this returns a preview
        instance; the live policy is still only mutated at the boundary."""
        if self._pending_policy is not None:
            return self._pending_policy
        if self._pending_knobs:
            preview = make_policy(self.cfg, name=self.policy.name)
            preview.reconfigure(**{**self.policy.knobs(),
                                   **self._pending_knobs})
            return preview
        return self.policy

    # -- trainer-facing state --------------------------------------------
    def active_mask(self) -> np.ndarray:
        """Devices that will start fresh work at the current sim time (up and
        not still carrying an in-flight gradient)."""
        t = self.time_s
        return np.array([self.churn.is_up(i, t) and i not in self.busy_until
                         for i in range(self.n)])

    # -- the round --------------------------------------------------------
    def round(self, *, waits: np.ndarray, batches: np.ndarray,
              floats_on_wire: float, extra_bytes: float = 0.0,
              label_div: Optional[np.ndarray] = None) -> RoundResult:
        # round boundary: queued policy/knob changes take effect now, so
        # this round plans (and in-flight work commits) under one policy
        self._apply_pending()
        T0 = self.time_s
        t_start = T0
        earlier_crashed: List[int] = []
        for retry in range(_MAX_IDLE_RETRIES):
            completions, started_set, crashed, crash_times = self._try_round(
                t_start, waits, batches, floats_on_wire, extra_bytes)
            if completions:
                break
            # nobody finished: every starter crashed mid-work and/or the rest
            # are down.  Advance to the earliest re-admission — after a crash
            # that is the recovery following the failure — and retry; the gap
            # (and the wasted attempt) is real sim time.  Keep the attempt's
            # crash records: a device still down at the final attempt must be
            # reported crashed so the trainer refunds its consumed batch.
            earlier_crashed.extend(crashed)
            self.idle_advances += 1
            candidates = []
            for i in range(self.n):
                if i in self.busy_until:
                    continue
                t_from = crash_times.get(i, t_start) + 1e-9
                candidates.append(self.churn.next_up_after(i, t_from))
            t_start = max(min(candidates), t_start + 1e-9)
        else:
            raise RuntimeError("fleet made no progress after "
                               f"{_MAX_IDLE_RETRIES} idle advances")
        # a device that crashed in an earlier attempt and restarted in the
        # final one is accounted by that attempt; anything still down lost
        # its work (and its batch) for real
        crashed = sorted(set(crashed) | {i for i in earlier_crashed
                                         if i not in started_set})
        # fresh starters read the current model version when they began
        starters = sorted(started_set)
        self.read_version[starters] = self.version
        self._work_batch[starters] = batches[starters]
        stale = {i: int(self.staleness[i]) for i in completions}
        plan = self.policy.plan(completions, stale)
        commit = plan.commit_time

        # bookkeeping: free participants/cancelled/crashed, carry stragglers
        for i in plan.participants + plan.cancelled + crashed:
            self.busy_until.pop(i, None)
        for i in plan.carried:
            self.busy_until[i] = completions[i]
        self.staleness[plan.participants] = 0
        self.staleness[crashed] = 0
        # cancelled work restarts fresh (a live switch into backup-workers
        # can cancel a straggler another policy had been carrying)
        self.staleness[plan.cancelled] = 0
        if plan.carried:
            self.staleness[plan.carried] += 1

        part = np.zeros(self.n, bool)
        part[plan.participants] = True
        started = np.zeros(self.n, bool)
        started[starters] = True
        # per-commit gradient staleness: commits since each participant read
        # the model (0 for work started and committed in the same round)
        commit_stale = np.full(self.n, -1, np.int64)
        commit_stale[part] = self.version - self.read_version[part]
        online = np.array([self.churn.up_fraction(i, T0, commit)
                           for i in range(self.n)])
        interrupted = [i for i in range(self.n) if online[i] < 1.0 - 1e-12]
        # the wait that actually gated this commit: only devices whose fresh
        # work was aggregated were waited for — a dropped or carried straggler
        # never blocked the barrier, so its wait must not be charged
        fresh = started & part
        max_wait = float(np.max(waits[fresh])) if fresh.any() else 0.0

        self._clock.advance_to(commit)
        self.version += 1
        self.rounds += 1
        self.total_participants += len(plan.participants)
        self.total_dropped += len(plan.cancelled)
        self.total_crashed += len(crashed)
        mean_stale = 0.0
        if plan.participants:
            s_vals = commit_stale[plan.participants]
            self.total_staleness += int(s_vals.sum())
            self.max_staleness = max(self.max_staleness, int(s_vals.max()))
            mean_stale = float(s_vals.mean())
        # statistical-heterogeneity signal: mean divergence over *this
        # commit's* participants — under partial-participation policies the
        # committed mix can be far more skewed than the fleet average
        mean_div = 0.0
        if label_div is not None and plan.participants:
            mean_div = float(np.asarray(label_div, np.float64)
                             [plan.participants].mean())
        tel = RoundTelemetry(
            round_index=self.rounds - 1, policy=self.policy.name,
            knobs=self.policy.knobs(), dt=commit - T0, commit_time=commit,
            n_started=len(started_set), n_participants=len(plan.participants),
            n_carried=len(plan.carried), n_dropped=len(plan.cancelled),
            n_crashed=len(crashed),
            committed_samples=float(self._work_batch[plan.participants].sum()),
            committed_wait=max_wait, mean_staleness=mean_stale,
            max_staleness=int(commit_stale[plan.participants].max(initial=0)),
            label_divergence=mean_div)
        self.telemetry.append(tel)
        self.policy.observe(tel)
        if self.tracker.active:
            self.tracker.log_metrics(fleet_round_record(tel),
                                     step=tel.round_index, kind=FLEET_ROUND)
        return RoundResult(dt=commit - T0, commit_time=commit,
                           started=started, part=part, online_frac=online,
                           max_wait=max_wait, crashed=crashed,
                           dropped=plan.cancelled, carried=plan.carried,
                           interrupted=interrupted, staleness=commit_stale,
                           version=self.version)

    def _try_round(self, t_start: float, waits, batches, floats_on_wire,
                   extra_bytes):
        """Run one round's event chains from ``t_start``; returns
        (completions, started, crashed, crash_times)."""
        started = [i for i in range(self.n)
                   if self.churn.is_up(i, t_start) and i not in self.busy_until]
        # lockstep charges the fleet-mean batch: average over devices with
        # real work only — a zero-batch starter (avail-masked after an idle
        # advance, or admitted with an empty stream) must not drag the mean
        # toward the 1.0 floor and distort everyone's compute charge
        real = [float(batches[i]) for i in started if batches[i] > 0]
        mean_batch = float(np.mean(real)) if real else 1.0
        q = ev.EventQueue()
        for i in started:
            # a device can drop while still gathering its mini-batch
            self._advance_or_fail(q, i, t_start, t_start + float(waits[i]),
                                  ev.STREAM_READY)
        for i, t_done in self.busy_until.items():
            # in-flight work was churn-checked through its completion when it
            # was first scheduled, so it lands unless the policy re-carries it
            q.push(t_done, ev.COMM_DONE, i)

        completions: Dict[int, float] = {}
        crashed: List[int] = []
        crash_times: Dict[int, float] = {}
        for e in q.drain():
            if e.kind == ev.STREAM_READY:
                t_c = e.time + self.device_compute_time(
                    e.device, float(batches[e.device]), mean_batch)
                self._advance_or_fail(q, e.device, e.time, t_c,
                                      ev.COMPUTE_DONE)
            elif e.kind == ev.COMPUTE_DONE:
                t_m = e.time + self.device_comm_time(
                    e.device, floats_on_wire, extra_bytes)
                self._advance_or_fail(q, e.device, e.time, t_m, ev.COMM_DONE)
            elif e.kind == ev.COMM_DONE:
                completions[e.device] = e.time
            elif e.kind == ev.DEVICE_DOWN:
                crashed.append(e.device)
                crash_times[e.device] = e.time
        return completions, set(started), crashed, crash_times

    def _advance_or_fail(self, q: ev.EventQueue, device: int, t0: float,
                         t1: float, kind: str) -> None:
        t_down = self.churn.next_down_in(device, t0, t1)
        if t_down is None:
            q.push(t1, kind, device)
        else:
            q.push(t_down, ev.DEVICE_DOWN, device)

    # -- reporting --------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        rounds = max(self.rounds, 1)
        return {
            "fleet_rounds": float(self.rounds),
            "fleet_part_rate": self.total_participants / (rounds * self.n),
            "fleet_dropped": float(self.total_dropped),
            "fleet_crashed": float(self.total_crashed),
            "fleet_idle_advances": float(self.idle_advances),
            "fleet_version": float(self.version),
            "fleet_mean_staleness": (self.total_staleness
                                     / max(self.total_participants, 1)),
            "fleet_max_staleness": float(self.max_staleness),
            "fleet_policy_switches": float(self.policy_switches),
        }

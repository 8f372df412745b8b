"""Synchronization policies + device churn for the fleet engine.

A policy looks at this round's per-device completion times (comm-done, in
absolute sim seconds) and decides (a) when the aggregation commits, (b) whose
gradients make it in, and (c) what happens to stragglers:

* ``FullSync``         — the paper's baseline: wait for everyone.
* ``BackupWorkers``    — drop the slowest ``drop_frac`` of this round's
  workers (Chen et al.'s backup-workers idea); their work is cancelled and
  they start fresh next round.
* ``BoundedStaleness`` — commit once a quorum has arrived; stragglers keep
  their work in flight and join a later commit, but any device excluded for
  ``bound`` consecutive rounds is force-waited (SSP-style staleness cap).
* ``SemiSync``         — K-batch barrier: commit as soon as the first ``k``
  gradients arrive; the rest stay in flight and join a later commit.  ``k=1``
  approaches fully-async, ``k=n`` recovers full-sync.
* ``Async``            — relaxed consistency (ADSP-style): every arrival
  commits immediately, so one engine round = one gradient (ties commit
  together, which makes a homogeneous zero-wait fleet degenerate to
  full-sync).  Staleness is unbounded here; the trainer bounds its *effect*
  via the parameter-snapshot ring (evicted versions aggregate with weight 0).

Policies are *live* objects: each exposes its tunable knobs (``semi_sync_k``,
``staleness_bound``, ``quorum_frac``, ``drop_frac``) as mutable, validated
attributes behind a uniform ``knobs()`` / ``reconfigure(**kw)`` protocol, and
an ``observe(telemetry)`` hook fed once per engine round.  The engine (and
the ``repro_torch.fleet.control`` controllers on top of it) reconfigure or swap
policies between rounds without rebuilding the engine — ``make_policy``
returns instances meant to be switched out mid-run.

``ChurnProcess`` is an alternating-renewal availability model (exponential
up/down durations per device, independent streams) used by the engine for
join/leave/crash-mid-round with re-admission.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.fleet.devices import (ASYNC, BACKUP_WORKERS, BOUNDED_STALENESS,
                                 FULL_SYNC, SEMI_SYNC, DeviceProfile,
                                 FleetConfig)


@dataclasses.dataclass(frozen=True)
class CommitPlan:
    commit_time: float
    participants: List[int]    # gradients aggregated at commit_time
    cancelled: List[int]       # work thrown away (restart next round)
    carried: List[int]         # work still in flight past the commit


def _check_drop_frac(v: float) -> float:
    if not 0.0 <= v < 1.0:
        raise ValueError(f"drop_frac must be in [0, 1), got {v}")
    return float(v)


def _check_staleness_bound(v: int) -> int:
    if v < 1:
        raise ValueError(f"staleness bound must be >= 1, got {v}")
    return int(v)


def _check_quorum_frac(v: float) -> float:
    if not 0.0 < v <= 1.0:
        raise ValueError(f"quorum_frac must be in (0, 1], got {v}")
    return float(v)


def _check_semi_sync_k(v: int) -> int:
    if v < 1:
        raise ValueError(f"semi-sync barrier size must be >= 1, got {v}")
    return int(v)


_KNOB_VALIDATORS = {
    "drop_frac": _check_drop_frac,
    "staleness_bound": _check_staleness_bound,
    "quorum_frac": _check_quorum_frac,
    "semi_sync_k": _check_semi_sync_k,
}


class SyncPolicy:
    """Stateful, live-reconfigurable commit policy.

    ``KNOBS`` names the attributes a controller may tune at runtime; every
    knob is validated through ``reconfigure``.  ``observe`` receives the
    engine's per-round telemetry record after each commit — the default is
    stateless, but a policy may adapt its own knobs from it.
    """

    name: str = "abstract"
    KNOBS: Sequence[str] = ()

    def plan(self, completions: Dict[int, float],
             staleness: Dict[int, int]) -> CommitPlan:
        """``completions``: device -> absolute comm-done time for every device
        with work that will finish (absent = crashed/offline this round).
        ``staleness``: rounds each of those devices has gone unaggregated."""
        raise NotImplementedError

    def observe(self, telemetry) -> None:
        """Per-round hook: ``telemetry`` is the engine's RoundTelemetry."""

    def knobs(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in self.KNOBS}

    def validate_knobs(self, **kw) -> Dict[str, float]:
        """Check knob names and values without applying them; returns the
        validated mapping.  Lets callers (the engine's deferred path) fail
        at request time instead of rounds later."""
        out = {}
        for k, v in kw.items():
            if k not in self.KNOBS:
                raise ValueError(
                    f"policy {self.name!r} has no knob {k!r}; "
                    f"tunable: {list(self.KNOBS) or 'none'}")
            out[k] = _KNOB_VALIDATORS[k](v)
        return out

    def reconfigure(self, **kw) -> None:
        # validate everything before applying anything: a bad value must
        # not leave the policy half-reconfigured
        for k, v in self.validate_knobs(**kw).items():
            setattr(self, k, v)

    def ring_depth(self, n_devices: int) -> int:
        """Parameter-snapshot ring depth this policy needs so in-flight
        commits can still find the version they read (trainer-side)."""
        return 2

    def can_carry(self) -> bool:
        """Whether commits under this policy can include work started at an
        older model version (=> the trainer must run the snapshot-ring path)."""
        return False


class FullSync(SyncPolicy):
    name = FULL_SYNC

    def plan(self, completions, staleness):
        commit = max(completions.values())
        return CommitPlan(commit, sorted(completions), [], [])


class BackupWorkers(SyncPolicy):
    """Commit at the ceil((1-drop_frac)*n)-th completion; cancel the rest."""
    name = BACKUP_WORKERS
    KNOBS = ("drop_frac",)

    def __init__(self, drop_frac: float = 0.125):
        self.drop_frac = _check_drop_frac(drop_frac)

    def plan(self, completions, staleness):
        order = sorted(completions, key=lambda i: (completions[i], i))
        keep = max(1, math.ceil((1.0 - self.drop_frac) * len(order)))
        commit = completions[order[keep - 1]]
        # everyone done by the cutoff participates (ties included)
        part = [i for i in order if completions[i] <= commit]
        cancelled = [i for i in order if completions[i] > commit]
        return CommitPlan(commit, part, cancelled, [])


class BoundedStaleness(SyncPolicy):
    """Commit once ``quorum_frac`` of workers arrive, but never let any
    device fall more than ``staleness_bound`` rounds behind."""
    name = BOUNDED_STALENESS
    KNOBS = ("staleness_bound", "quorum_frac")

    def __init__(self, bound: int = 4, quorum_frac: float = 0.5):
        self.staleness_bound = _check_staleness_bound(bound)
        self.quorum_frac = _check_quorum_frac(quorum_frac)

    @property
    def bound(self) -> int:                     # pre-refactor alias
        return self.staleness_bound

    def plan(self, completions, staleness):
        order = sorted(completions, key=lambda i: (completions[i], i))
        quorum = max(1, math.ceil(self.quorum_frac * len(order)))
        commit = completions[order[quorum - 1]]
        # devices at the staleness bound must be waited for (SSP barrier)
        overdue = [i for i in order
                   if staleness.get(i, 0) >= self.staleness_bound]
        if overdue:
            commit = max(commit, max(completions[i] for i in overdue))
        part = [i for i in order if completions[i] <= commit]
        carried = [i for i in order if completions[i] > commit]
        return CommitPlan(commit, part, [], carried)

    def ring_depth(self, n_devices: int) -> int:
        # a carried gradient is at most ``staleness_bound`` commits stale,
        # plus slack for the force-wait round itself
        return max(4, self.staleness_bound + 2)

    def can_carry(self) -> bool:
        return True


class SemiSync(SyncPolicy):
    """Commit at the k-th earliest arrival; later arrivals stay in flight.
    ``semi_sync_k=1`` approaches fully-async; ``semi_sync_k>=n`` recovers
    full-sync — one mutable knob spans the whole consistency spectrum."""
    name = SEMI_SYNC
    KNOBS = ("semi_sync_k",)

    def __init__(self, k: int = 2):
        self.semi_sync_k = _check_semi_sync_k(k)

    @property
    def k(self) -> int:                         # pre-refactor alias
        return self.semi_sync_k

    def plan(self, completions, staleness):
        order = sorted(completions, key=lambda i: (completions[i], i))
        kth = min(self.semi_sync_k, len(order))
        commit = completions[order[kth - 1]]
        part = [i for i in order if completions[i] <= commit]
        carried = [i for i in order if completions[i] > commit]
        return CommitPlan(commit, part, [], carried)

    def ring_depth(self, n_devices: int) -> int:
        # steady-state staleness ~ commits per device cycle - 1
        # = ceil(n/k) - 1; keep a few cycles of slack
        cycles = math.ceil(n_devices / max(self.semi_sync_k, 1))
        return max(8, 4 * cycles)

    def can_carry(self) -> bool:
        return True


class Async(SemiSync):
    """Commit every arrival the moment it lands: semi-sync with k pinned
    to 1 (no knobs — escalate to SemiSync to widen the barrier)."""
    name = ASYNC
    KNOBS = ()

    def __init__(self):
        super().__init__(k=1)


_POLICY_FAMILIES = {
    FULL_SYNC: FullSync,
    BACKUP_WORKERS: BackupWorkers,
    BOUNDED_STALENESS: BoundedStaleness,
    SEMI_SYNC: SemiSync,
    ASYNC: Async,
}


def make_policy(cfg: FleetConfig, name: Optional[str] = None) -> SyncPolicy:
    """Instantiate a live policy from the config's knobs.  ``name`` overrides
    ``cfg.policy`` so controllers can escalate between families while keeping
    the operator's other knob settings."""
    policy = cfg.policy if name is None else name
    if policy == FULL_SYNC:
        return FullSync()
    if policy == BACKUP_WORKERS:
        return BackupWorkers(cfg.drop_frac)
    if policy == BOUNDED_STALENESS:
        return BoundedStaleness(cfg.staleness_bound, cfg.quorum_frac)
    if policy == SEMI_SYNC:
        return SemiSync(cfg.semi_sync_k)
    if policy == ASYNC:
        return Async()
    raise ValueError(f"unknown sync policy {policy!r}; options: "
                     f"{sorted(_POLICY_FAMILIES)}")


# ---------------------------------------------------------------------------
# churn


class ChurnProcess:
    """Alternating-renewal up/down schedule, lazily sampled per device.

    Each device draws Exp(mtbf) up-durations and Exp(mttr) down-durations from
    its own generator (spawned from one seed), so schedules are deterministic
    regardless of query order.  All devices start up at t=0.
    """

    def __init__(self, profiles: Sequence[DeviceProfile], seed: int = 0,
                 enabled: bool = True):
        self.profiles = list(profiles)
        self.enabled = enabled
        seqs = np.random.SeedSequence([seed, 0xC4D2]).spawn(len(profiles))
        self._rngs = [np.random.default_rng(s) for s in seqs]
        # per-device transition times: state flips at each time; even index ->
        # goes down, odd index -> comes back up (devices start up at t=0)
        self._flips: List[List[float]] = [[] for _ in profiles]
        self._sampled_until = [0.0 for _ in profiles]

    def _ensure(self, i: int, t: float) -> None:
        prof = self.profiles[i]
        if not (self.enabled and prof.can_fail):
            return
        rng, flips = self._rngs[i], self._flips[i]
        while self._sampled_until[i] <= t:
            up = len(flips) % 2 == 0
            mean = prof.mtbf_s if up else prof.mttr_s
            cur = flips[-1] if flips else 0.0
            flips.append(cur + float(rng.exponential(mean)))
            self._sampled_until[i] = flips[-1]

    def is_up(self, i: int, t: float) -> bool:
        if not (self.enabled and self.profiles[i].can_fail):
            return True
        self._ensure(i, t)
        n_before = np.searchsorted(self._flips[i], t, side="right")
        return int(n_before) % 2 == 0

    def next_down_in(self, i: int, t0: float, t1: float):
        """First down-transition in (t0, t1], or None.  Assumes up at t0."""
        if not (self.enabled and self.profiles[i].can_fail):
            return None
        self._ensure(i, t1)
        flips = self._flips[i]
        k = int(np.searchsorted(flips, t0, side="right"))
        if k % 2 == 0 and k < len(flips) and flips[k] <= t1:
            return flips[k]
        return None

    def next_up_after(self, i: int, t: float) -> float:
        """Earliest time >= t the device is up (t itself if already up)."""
        if self.is_up(i, t):
            return t
        flips = self._flips[i]
        k = int(np.searchsorted(flips, t, side="right"))
        # k is odd (down); the next flip brings it back up
        self._ensure(i, flips[k] if k < len(flips) else t)
        return flips[k]

    def up_fraction(self, i: int, t0: float, t1: float) -> float:
        """Fraction of [t0, t1] the device was up (stream-arrival scaling)."""
        if t1 <= t0:
            return 1.0
        if not (self.enabled and self.profiles[i].can_fail):
            return 1.0
        self._ensure(i, t1)
        flips = self._flips[i]
        up_time, cur, up = 0.0, t0, self.is_up(i, t0)
        k = int(np.searchsorted(flips, t0, side="right"))
        while k < len(flips) and flips[k] < t1:
            if up:
                up_time += flips[k] - cur
            cur, up = flips[k], not up
            k += 1
        if up:
            up_time += t1 - cur
        return up_time / (t1 - t0)

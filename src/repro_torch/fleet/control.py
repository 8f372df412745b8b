"""Adaptive synchronization controllers: the fleet's live control plane.

The engine exposes a reconfigurable policy stack — mutable knobs
behind ``SyncPolicy.reconfigure`` and a round-boundary-deferred
``FleetEngine.set_policy`` — plus a rolling ``RoundTelemetry`` window.  A
``SyncController`` closes the loop: it watches realised telemetry + training
loss and retunes the commit granularity online, so the operator no longer
has to guess the right policy for a fleet whose stream rates, churn, and
compute heterogeneity drift over time.

``HillClimbController`` is the first controller, after ADSP (Hu, Wang & Wu:
tune the commit rate online from realised throughput) and DISTREAL (Rapp et
al.: runtime resource-aware adaptation).  It treats the semi-sync barrier
size ``k`` as a single axis spanning the whole consistency spectrum —
``k=1`` is fully-async, ``k=n`` is full-sync — and hill-climbs it to
maximise **loss progress per simulated second**, measured over fixed windows
of engine rounds on an EWMA-smoothed loss.  Two design rules:

* **Start relaxed.**  Exploration cost is asymmetric: a window of relaxed
  rounds is cheap (commits gate on the fastest arrivals) while a window of
  synchronous rounds costs a full straggler barrier per round.  The
  controller therefore starts at the relaxed end (``k=1`` unless
  ``controller_start_k`` says otherwise) and *tightens the barrier only when
  a probe window proves it pays*; ties prefer the smaller k.
* **Escalate families at the edges.**  A reference that settles at ``k=1``
  runs as the ``async`` policy, at ``k>=n`` as ``full-sync``; probes in
  between run as ``semi-sync``.  Family switches ride the same deferred
  ``set_policy`` path as knob changes, so every move lands on a round
  boundary.

Controllers are configured from ``FleetConfig.controller`` fields and driven
by the trainer via ``FleetEngine.controller_update(loss)`` once per round.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.fleet.devices import ASYNC, FULL_SYNC, SEMI_SYNC, FleetConfig
from repro_torch.fleet.policies import Async, SemiSync, SyncPolicy

# hill-climb phases
_REF = "ref"        # measuring the reference configuration's objective
_PROBE = "probe"    # measuring a candidate k
_CONFIRM = "confirm"  # re-measuring the reference to bracket the probe
_SETTLE = "settle"  # tracking the reference, re-probing periodically


class ClimbCore:
    """Reusable windowed hill climb over one bounded integer axis.

    The domain-independent phase machine under :class:`HillClimbController`
    (and the serving-side ``ServeController``): probe a neighbouring value,
    bracket ambiguous probes with a confirm window to cancel linear
    objective drift, accept with doubling steps, revert with a direction
    flip, and re-probe periodically from the settled reference.  Values are
    integers in ``[lo, hi]``; ``relax_dir`` marks the direction whose end is
    *cheaper to run* (ties there may be accepted — hook ``tie_relax``).

    :meth:`observe` is fed one windowed objective (higher is better) per
    call and returns ``(value_to_run_next, reason)`` when the configuration
    should change (reason in ``probe|confirm|accept|revert``) or None.
    Callers must invoke :meth:`note_scale` with every windowed objective —
    including warm-up windows never fed to ``observe`` — so the noise floor
    tracks the objective's true scale.
    """

    def __init__(self, lo: int, hi: int, start: int, tol: float = 0.05,
                 probe_every: int = 6, relax_dir: int = -1,
                 tie_relax=None, probe_dirs=None):
        self.lo, self.hi = int(lo), int(hi)
        self.tol = float(tol)
        self.probe_every = max(int(probe_every), 1)
        self.relax_dir = 1 if relax_dir >= 0 else -1
        self.ref = min(max(int(start), self.lo), self.hi)
        self.cand: Optional[int] = None
        self.direction = self.relax_dir      # prefer relaxing when exploring
        self.step = 1
        self.phase = _REF
        self.settled = 0
        self.ref_obj: Optional[float] = None
        self.max_obj = 0.0   # largest |objective| seen: noise floor scale
        self.trend = 0.0     # per-window drift of the reference objective
        self._cand_obj = 0.0
        self._tie_relax = tie_relax if tie_relax is not None \
            else (lambda: True)
        self._probe_dirs = probe_dirs if probe_dirs is not None \
            else (lambda: (self.direction, -self.direction))

    def note_scale(self, obj: float) -> None:
        self.max_obj = max(self.max_obj, abs(obj))

    def _relaxing(self, cand: int) -> bool:
        return (cand - self.ref) * self.relax_dir > 0

    def _margin(self, scale: float) -> float:
        # once the objective collapses toward 0 a purely relative tolerance
        # would let sign-noise drive the climb; the floor (tol x the largest
        # |objective| ever seen) keeps moves that don't clear real signal
        # from being accepted
        return self.tol * abs(scale) + self.tol * self.max_obj

    def observe(self, obj: float):
        if self.phase == _REF:
            self.ref_obj = obj
            return self.propose_probe()
        if self.phase == _PROBE:
            m = self._margin(self.ref_obj)
            if self._relaxing(self.cand) and obj >= self.ref_obj + m:
                # relaxing and clearly winning even against the raw (drift-
                # uncorrected) reference: accept without a confirm window
                return self._accept_move(obj)
            if not self._relaxing(self.cand) and self.trend >= 0.0 \
                    and obj < self.ref_obj - m:
                # tightening and clearly losing while the objective is not
                # decaying (decay would deflate a late-measured probe):
                # reject without a confirm window
                return self._reject_move()
            # ambiguous: bracket the probe with a second reference window —
            # comparing the candidate against the *mean* of the two
            # surrounding reference windows cancels linear objective drift
            self._cand_obj = obj
            self.phase = _CONFIRM
            return (self.ref, "confirm")
        if self.phase == _CONFIRM:
            base = 0.5 * (self.ref_obj + obj)
            self.trend = 0.5 * self.trend + 0.25 * (obj - self.ref_obj)
            m = self._margin(base)
            if self._relaxing(self.cand) and self._tie_relax():
                # relaxing: accept ties — the relaxed end is cheaper to run,
                # so on a plateau prefer it.  The hook lets a domain revoke
                # the tie rule (e.g. under heavy label skew)
                ok = self._cand_obj >= base - m
            else:
                ok = self._cand_obj > base + m
            self.ref_obj = obj
            if ok:
                return self._accept_move(self._cand_obj)
            return self._reject_move(already_at_ref=True)
        # _SETTLE: keep the reference objective (and its drift) fresh — a
        # stale reference would mis-score every probe against the
        # objective's own trajectory
        self.trend = 0.5 * self.trend + 0.5 * (obj - self.ref_obj)
        self.ref_obj = obj
        self.settled += 1
        if self.settled >= self.probe_every:
            return self.propose_probe()
        return None

    def _accept_move(self, cand_obj: float):
        self.ref, self.ref_obj = self.cand, cand_obj
        self.step *= 2                           # accelerate while winning
        # one settle window at the new reference, then probe onward
        self.phase, self.settled = _SETTLE, self.probe_every - 1
        return (self.ref, "accept")

    def _reject_move(self, already_at_ref: bool = False):
        self.phase, self.settled = _SETTLE, 0
        self.step = 1
        self.direction = -self.direction
        if already_at_ref:                       # the confirm window was
            return None                          # already the revert
        return (self.ref, "revert")

    def propose_probe(self):
        for d in self._probe_dirs():
            v = min(max(self.ref + d * self.step, self.lo), self.hi)
            if v != self.ref:
                self.direction, self.cand, self.phase = d, v, _PROBE
                return (v, "probe")
        self.phase, self.settled = _SETTLE, 0    # degenerate axis
        return None


@dataclasses.dataclass(frozen=True)
class ControlAction:
    """A controller decision, applied via the engine's deferred path:
    ``policy`` switches the family (None keeps it), ``knobs`` reconfigure
    the target policy."""
    policy: Optional[str] = None
    knobs: Dict[str, float] = dataclasses.field(default_factory=dict)
    reason: str = ""


class SyncController:
    """Interface: observe per-round telemetry + loss, emit policy actions."""

    name: str = "abstract"

    def start_policy(self, cfg: FleetConfig,
                     n_devices: int) -> Optional[SyncPolicy]:
        """Policy to install at engine construction; None keeps
        ``cfg.policy``.  Lets a controller own its starting point instead of
        inheriting a static guess."""
        return None

    def update(self, telemetry, loss: float) -> Optional[ControlAction]:
        """Called once per engine round with the round's telemetry record
        and the trainer's realised loss; returns an action or None."""
        raise NotImplementedError


class HillClimbController(SyncController):
    """ADSP-style windowed hill climb over the semi-sync barrier size.

    The phase machine lives in :class:`ClimbCore` (one axis, ``k`` in
    ``[1, n]``, relaxed end = smaller k); this class owns the fleet-domain
    pieces — the gradient-time windowing of the loss objective, the label-
    skew EWMA that flips the probe order and revokes the relax-tie rule,
    and the mapping from barrier size to policy family.
    """

    name = "hill-climb"

    def __init__(self, n_devices: int, window: int = 4, tol: float = 0.05,
                 start_k: Optional[int] = None, probe_every: int = 6,
                 skew_threshold: float = 0.35):
        self.n = max(int(n_devices), 1)
        self.window = max(int(window), 1)
        self.tol = float(tol)
        self.probe_every = max(int(probe_every), 1)
        self.skew_threshold = float(skew_threshold)
        # EWMA of per-commit label divergence (the data plane's signal via
        # RoundTelemetry); stays 0.0 on IID streams / legacy data sources
        self.div_ewma = 0.0
        self.core = ClimbCore(
            1, self.n, 1 if start_k is None else int(start_k),
            tol=self.tol, probe_every=self.probe_every, relax_dir=-1,
            # under heavy label skew a relaxed commit aggregates an
            # unrepresentative mix: relaxing must prove a win, never ride
            # a tie, and probes try the tighter barrier first
            tie_relax=lambda: not self._skewed(),
            probe_dirs=lambda: ((1, -1) if self._skewed()
                                else (self.core.direction,
                                      -self.core.direction)))
        self.actions: List[ControlAction] = []       # decision log
        # window accumulators (EWMA-smoothed loss, sim seconds); the first
        # window only warms the EWMA up — its objective is transient-skewed.
        # Windows are measured in *committed gradients* (``window`` fleet-
        # equivalents), not rounds: an async round commits one gradient and
        # a full-sync round commits n, so round-counted windows would give a
        # relaxed policy n-times less evidence (and n-times the variance)
        # per decision than a synchronous one
        self._warm = True
        self._ema: Optional[float] = None
        self._win_start: Optional[float] = None
        self._win_dt = 0.0
        self._win_grads = 0

    # -- lifecycle --------------------------------------------------------
    def start_policy(self, cfg, n_devices):
        return Async() if self.ref_k <= 1 else SemiSync(self.ref_k)

    def update(self, telemetry, loss):
        loss = float(loss)
        # EWMA weight scales with the commit's share of the fleet: a lone
        # async committer's (noisy, single-batch) loss moves the estimate
        # 1/n as much as a full barrier's, so smoothing is uniform in
        # gradient-time across every k
        alpha = 1.0 - 0.5 ** (telemetry.n_participants / self.n)
        if math.isfinite(loss) and alpha > 0.0:
            self._ema = (loss if self._ema is None
                         else (1.0 - alpha) * self._ema + alpha * loss)
        if alpha > 0.0:
            # smoothed in gradient-time like the loss: a lone skewed async
            # committer moves the skew estimate 1/n as much as a full barrier
            self.div_ewma = ((1.0 - alpha) * self.div_ewma + alpha
                             * float(getattr(telemetry, "label_divergence",
                                             0.0)))
        if self._win_start is None:
            self._win_start = self._ema
        self._win_dt += telemetry.dt
        self._win_grads += telemetry.n_participants
        if self._win_grads < self.window * self.n or self._ema is None:
            return None
        # window boundary: loss progress per simulated second
        obj = (self._win_start - self._ema) / max(self._win_dt, 1e-12)
        self._win_grads, self._win_dt, self._win_start = 0, 0.0, self._ema
        self.core.note_scale(obj)
        if self._warm:
            self._warm = False
            return None
        move = self.core.observe(obj)
        act = None if move is None else self._action_for(*move)
        if act is not None:
            self.actions.append(act)
        return act

    # -- the climb (delegated to ClimbCore) -------------------------------
    @property
    def ref_k(self) -> int:
        return self.core.ref

    @property
    def cand_k(self) -> Optional[int]:
        return self.core.cand

    @property
    def phase(self) -> str:
        return self.core.phase

    @property
    def max_obj(self) -> float:
        return self.core.max_obj

    def _skewed(self) -> bool:
        """Heavy statistical heterogeneity on the committed mixes: back off
        the relax-first bias (see ``FleetConfig.controller_skew_threshold``)."""
        return self.div_ewma > self.skew_threshold

    def _propose_probe(self) -> Optional[ControlAction]:
        move = self.core.propose_probe()
        return None if move is None else self._action_for(*move)

    def _action_for(self, k: int, reason: str) -> ControlAction:
        """Map a barrier size to its policy family: the spectrum's edges
        escalate out of semi-sync entirely."""
        tag = f"{reason}:k={k}"
        if k <= 1:
            return ControlAction(policy=ASYNC, reason=tag)
        if k >= self.n:
            return ControlAction(policy=FULL_SYNC, reason=tag)
        return ControlAction(policy=SEMI_SYNC, knobs={"semi_sync_k": k},
                             reason=tag)


_CONTROLLERS = {"hill-climb": HillClimbController}


def make_controller(cfg: FleetConfig, n_devices: int) -> SyncController:
    if cfg.controller not in _CONTROLLERS:
        raise ValueError(f"unknown controller {cfg.controller!r}; "
                         f"options: {sorted(_CONTROLLERS)}")
    return _CONTROLLERS[cfg.controller](
        n_devices, window=cfg.controller_window, tol=cfg.controller_tol,
        start_k=cfg.controller_start_k,
        probe_every=cfg.controller_probe_every,
        skew_threshold=cfg.controller_skew_threshold)

"""Per-device profiles + fleet presets for the discrete-event edge engine.

The legacy ``EdgeClock`` models a fleet of identical K80s on identical links;
real edge fleets mix device classes (Deep-Edge, arXiv:2004.05740) and
availability patterns (DISTREAL, arXiv:2112.08761).  A ``DeviceProfile``
captures what the engine needs per device:

* ``compute_mult`` — multiplier on the calibrated seconds/iteration (1.0 = the
  paper's reference K80; a Jetson-class SoC is ~2-3x slower, a phone 3-5x);
* ``bandwidth_gbps`` — this device's absolute link rate, or ``None`` to
  inherit the base clock's bandwidth (the calibrated ``bandwidth_efficiency``
  applies on top either way).  Reference-class presets inherit, so legacy
  equivalence holds at any configured bandwidth;
* ``mtbf_s`` / ``mttr_s`` — mean time between failures / to recovery for the
  alternating-renewal availability model (``inf`` = always up).  "Failure"
  covers battery duty-cycling, backgrounding, and network drops alike;
* ``volatile_buffer`` — whether going down loses the device's stream buffer
  (crash semantics; re-admission starts from an empty queue).

Presets return one profile per device and are deterministic in (n, seed):

* ``k80-uniform``  — the paper's setup; degenerate case that must reproduce
  ``EdgeClock`` sim-times exactly under full-sync.
* ``jetson-mixed`` — heterogeneous compute (0.6x-2.75x); desktops/K80s on
  the base-clock link, Jetsons on thin 1 Gbps links with rare long outages;
  the straggler-policy showcase.
* ``phone-flaky``  — slow devices, thin links, frequent churn with buffer
  loss; the worst case the paper's lockstep model cannot express.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Union

import numpy as np

FULL_SYNC = "full-sync"
BACKUP_WORKERS = "backup-workers"
BOUNDED_STALENESS = "bounded-staleness"
SEMI_SYNC = "semi-sync"
ASYNC = "async"

# policies whose commits can include work started at an older model version
# (the trainer keeps a parameter-snapshot ring so those gradients are
# evaluated at the params the device actually read).  Kept as a constant for
# reference/compat; the live control plane asks the policy *instance* via
# ``SyncPolicy.can_carry()`` since the policy can change mid-run.
CARRY_POLICIES = (BOUNDED_STALENESS, SEMI_SYNC, ASYNC)

LOCKSTEP = "lockstep"      # charge every device the fleet-mean batch (legacy)
PER_DEVICE = "per-device"  # charge each device its own batch
AUTO = "auto"              # lockstep iff the fleet is homogeneous


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    compute_mult: float = 1.0
    bandwidth_gbps: Optional[float] = None   # None: inherit the base clock's
    mtbf_s: float = math.inf
    mttr_s: float = 30.0
    volatile_buffer: bool = False

    @property
    def can_fail(self) -> bool:
        return math.isfinite(self.mtbf_s)


def _k80_uniform(n: int, rng: np.random.Generator) -> List[DeviceProfile]:
    return [DeviceProfile(f"k80-{i}") for i in range(n)]


def _jetson_mixed(n: int, rng: np.random.Generator) -> List[DeviceProfile]:
    """40% fast desktops, 40% reference-class, 20% slow Jetson stragglers —
    a straggler *tail* (coverable by a backup-worker drop budget) rather than
    a straggler third."""
    out = []
    classes = [
        ("desktop", 0.6, None, math.inf, 30.0),   # None: base-clock link
        ("k80", 1.0, None, math.inf, 30.0),
        ("desktop", 0.6, None, math.inf, 30.0),
        ("k80", 1.0, None, math.inf, 30.0),
        ("jetson", 2.5, 1.0, 1800.0, 60.0),       # rare long outages
    ]
    for i in range(n):
        name, mult, bw, mtbf, mttr = classes[i % len(classes)]
        jitter = float(rng.uniform(0.9, 1.1))
        out.append(DeviceProfile(f"{name}-{i}", compute_mult=mult * jitter,
                                 bandwidth_gbps=bw, mtbf_s=mtbf, mttr_s=mttr))
    return out


def _phone_flaky(n: int, rng: np.random.Generator) -> List[DeviceProfile]:
    """Slow, thin-linked, frequently-churning handsets with volatile buffers."""
    out = []
    for i in range(n):
        out.append(DeviceProfile(
            f"phone-{i}",
            compute_mult=float(rng.uniform(2.0, 4.0)),
            bandwidth_gbps=float(rng.uniform(0.2, 1.0)),
            mtbf_s=float(rng.uniform(60.0, 240.0)),
            mttr_s=float(rng.uniform(10.0, 60.0)),
            volatile_buffer=True))
    return out


PRESETS = {
    "k80-uniform": _k80_uniform,
    "jetson-mixed": _jetson_mixed,
    "phone-flaky": _phone_flaky,
}


def make_fleet(preset: str, n_devices: int, seed: int = 0) -> List[DeviceProfile]:
    """Instantiate ``n_devices`` profiles from a named preset."""
    if preset not in PRESETS:
        raise ValueError(f"unknown fleet preset {preset!r}; "
                         f"options: {sorted(PRESETS)}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xF1EE7]))
    return PRESETS[preset](n_devices, rng)


def is_homogeneous(profiles: Sequence[DeviceProfile]) -> bool:
    p0 = profiles[0]
    return all(p.compute_mult == p0.compute_mult
               and p.bandwidth_gbps == p0.bandwidth_gbps for p in profiles)


def link_gbps(profile: DeviceProfile, base_gbps: float) -> float:
    """A profile's link rate, inheriting the base clock's when unset."""
    return base_gbps if profile.bandwidth_gbps is None \
        else profile.bandwidth_gbps


@dataclasses.dataclass
class FleetConfig:
    """Trainer-facing knob bundle: which fleet, which sync policy, churn."""
    profile: Union[str, Sequence[DeviceProfile]] = "k80-uniform"
    policy: str = FULL_SYNC
    drop_frac: float = 0.125          # backup-workers: drop slowest fraction
    staleness_bound: int = 4          # bounded-staleness: max rounds excluded
    quorum_frac: float = 0.5          # bounded-staleness: commit quorum
    semi_sync_k: int = 2              # semi-sync: arrivals per barrier group
    churn: bool = False               # enable the availability model
    compute_model: str = AUTO         # lockstep | per-device | auto
    # --- adaptive-sync control plane (repro_torch.fleet.control) ---
    # rolling rounds of RoundTelemetry the engine keeps for controllers
    telemetry_window: int = 32
    # attach a controller ("hill-climb") that retunes the live policy from
    # realised loss-progress-per-sim-second; None keeps the static policy.
    # The controller owns the policy stack: it starts from the relaxed end
    # of the semi-sync spectrum (cheap rounds => cheap exploration) and
    # treats ``policy`` as the no-controller fallback.
    controller: Optional[str] = None
    # decision window, in fleet-equivalents of *committed gradients* (the
    # window closes after controller_window * n_devices gradients — ~this
    # many rounds under full-sync, n times more under async), so every
    # decision rests on the same evidence whatever the commit granularity
    controller_window: int = 4
    controller_tol: float = 0.05      # relative gain needed to accept a move
    controller_start_k: Optional[int] = None   # initial semi-sync k (None: 1)
    controller_probe_every: int = 6   # settled windows between re-probes
    # statistical heterogeneity: when the EWMA of per-commit label divergence
    # (the data plane's ``label_divergence``) exceeds this, the controller flips its exploration
    # bias — probe *tighter* barriers first and stop accepting relax-ties —
    # because relaxed commits aggregate an unrepresentative label mix.
    # Divergence is in [0, 1); 0.35 ~ "committed mixes share barely half
    # their mass with the global mix".  Ignored without a data-plane signal.
    controller_skew_threshold: float = 0.35
    # comm-bytes source: None keeps the analytic ring formula (bit-exact with
    # the legacy EdgeClock under homogeneous full-sync); any object exposing
    # ``bytes_for(floats_on_wire) -> bytes`` overrides it —
    # repro_torch.dist.calibrate.CommCalibration supplies one recorded from
    # the DDP programs
    comm_model: Optional[object] = None
    seed: int = 0

    def resolve_profiles(self, n_devices: int) -> List[DeviceProfile]:
        if isinstance(self.profile, str):
            return make_fleet(self.profile, n_devices, self.seed)
        profiles = list(self.profile)
        if len(profiles) != n_devices:
            raise ValueError(f"fleet has {len(profiles)} profiles for "
                             f"{n_devices} devices")
        return profiles

    def resolve_compute_model(self, profiles: Sequence[DeviceProfile]) -> str:
        if self.compute_model != AUTO:
            return self.compute_model
        return LOCKSTEP if is_homogeneous(profiles) else PER_DEVICE

"""The port's fleet (``repro_torch.fleet``) and the trainer's fleet and
relaxed-consistency paths, against the reference, on the CPU.

* The fleet modules are carried over with their numpy logic unchanged: the
  scenarios of ``tests/test_fleet.py`` (events, presets, churn, the five
  sync policies, the engine, the hill-climb controller) run in both
  packages and give identical results, and the reference's claims hold on
  the port.
* The trainer on the port: ``k80-uniform`` with full-sync, semi-sync or
  async matches the port's legacy ``EdgeClock`` run to rel 1e-9 in sim
  time; relaxed policies commit stale gradients; refunds and buffer
  conservation hold; ``jetson-mixed`` async and semi-sync histories, a live
  policy switch and the hill-climb controller match the reference's (host
  fields identical, loss within the bound of ``test_torch_scadles.py``).
* A tracked fleet run is bit-exact with an untracked one and emits
  ``train_round`` and ``fleet_round`` records.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import repro.fleet as jfleet
from repro.core.simclock import EdgeClock as JEdgeClock
from repro.core.simclock import EdgeClockConfig as JClockConfig
from repro.data import ClassClusterData as JData
from repro.data import DeviceDataSource as JSource
from repro.core import ScaDLESConfig as JConfig
from repro.core import ScaDLESTrainer as JTrainer
import repro_torch.fleet as tfleet
from repro_torch.core import ScaDLESConfig, ScaDLESTrainer
from repro_torch.core.simclock import EdgeClock, EdgeClockConfig
from repro_torch.data import ClassClusterData, DeviceDataSource
from repro_torch.fleet import (COMM_DONE, COMPUTE_DONE, STREAM_READY, Async,
                               BackupWorkers, BoundedStaleness, ChurnProcess,
                               DeviceProfile, EventQueue, FleetConfig,
                               FleetEngine, FullSync, SemiSync, make_fleet,
                               make_policy)
from repro_torch.models.mlp import make_mlp
from repro_torch.obs import FLEET_ROUND, TRAIN_ROUND, MemoryTracker
from test_torch_scadles import (LOSS_ATOL, LOSS_RTOL, jax_mlp,
                                port_model_from)

PKGS = [(jfleet, JClockConfig, JEdgeClock), (tfleet, EdgeClockConfig,
                                             EdgeClock)]


def both(fn):
    """``fn(fleet_module, EdgeClockConfig, EdgeClock)`` in the reference and
    in the port; asserts the two results are equal and returns the port's."""
    ref, port = (fn(*pkg) for pkg in PKGS)
    assert port == ref
    return port


def _as_plain(x):
    """A RoundResult / plan / summary as plain comparable values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _as_plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# events, presets, churn


def test_event_queue_orders_by_time_then_fifo():
    def run(fl, *_):
        q = fl.EventQueue()
        q.push(2.0, fl.COMM_DONE, 0)
        q.push(1.0, fl.STREAM_READY, 1)
        q.push(1.0, fl.COMPUTE_DONE, 2)
        return [(e.kind, e.device) for e in q.drain()]
    assert both(run) == [(STREAM_READY, 1), (COMPUTE_DONE, 2),
                         (COMM_DONE, 0)]
    assert EventQueue is tfleet.events.EventQueue


@pytest.mark.parametrize("preset", ["k80-uniform", "jetson-mixed",
                                    "phone-flaky"])
@pytest.mark.parametrize("n,seed", [(4, 0), (9, 3), (16, 0)])
def test_presets_identical(preset, n, seed):
    profs = both(lambda fl, *_: [dataclasses.asdict(p) for p in
                                 fl.make_fleet(preset, n, seed=seed)])
    assert len(profs) == n
    assert make_fleet(preset, n, seed) == make_fleet(preset, n, seed)


def test_preset_claims_hold_on_the_port():
    assert len({p.compute_mult for p in make_fleet("jetson-mixed", 9, 3)}) > 1
    assert all(p.compute_mult == 1.0 and not p.can_fail
               for p in make_fleet("k80-uniform", 4))
    assert all(p.can_fail and p.volatile_buffer
               for p in make_fleet("phone-flaky", 4))
    with pytest.raises(ValueError):
        make_fleet("no-such-preset", 4)
    cfg = FleetConfig(profile="k80-uniform")
    assert cfg.resolve_compute_model(cfg.resolve_profiles(4)) == "lockstep"
    cfg2 = FleetConfig(profile="phone-flaky")
    assert cfg2.resolve_compute_model(
        cfg2.resolve_profiles(4)) == "per-device"
    with pytest.raises(ValueError):
        FleetConfig(profile=[DeviceProfile("x")]).resolve_profiles(2)


def test_churn_identical_and_consistent():
    def run(fl, *_):
        profs = fl.make_fleet("phone-flaky", 4, seed=1)
        c = fl.ChurnProcess(profs, seed=7)
        out = [c.is_up(i, 500.0) for i in range(4)]
        out += [c.up_fraction(i, 0.0, 1000.0) for i in reversed(range(4))]
        out += [c.next_down_in(i, 0.0, 1e4) for i in range(4)]
        t_down = c.next_down_in(0, 0.0, 1e5)
        out += [t_down, c.next_up_after(0, t_down + 1e-9)]
        return out
    out = both(run)
    assert all(0.0 <= f <= 1.0 for f in out[4:8])
    off = ChurnProcess(make_fleet("phone-flaky", 3, seed=0), seed=0,
                       enabled=False)
    assert all(off.is_up(i, 1e6) for i in range(3))
    assert off.up_fraction(1, 0.0, 1e6) == 1.0
    assert off.next_down_in(2, 0.0, 1e6) is None
    c = ChurnProcess([DeviceProfile("d", mtbf_s=10.0, mttr_s=10.0)], seed=0)
    c._flips[0] = [10.0, 20.0]
    c._sampled_until[0] = 1e9
    assert c.up_fraction(0, 0.0, 10.0) == pytest.approx(1.0)
    assert c.up_fraction(0, 10.0, 20.0) == pytest.approx(0.0)
    assert c.up_fraction(0, 5.0, 25.0) == pytest.approx(0.5)
    assert not c.is_up(0, 10.0) and c.is_up(0, 20.0)


# ---------------------------------------------------------------------------
# sync policies

COMPLETIONS = {0: 10.0, 1: 11.0, 2: 12.0, 3: 40.0}
NO_STALE = {i: 0 for i in COMPLETIONS}
POLICIES = [("FullSync", {}), ("BackupWorkers", {"drop_frac": 0.25}),
            ("BoundedStaleness", {"bound": 2, "quorum_frac": 0.5}),
            ("SemiSync", {"k": 2}), ("SemiSync", {"k": 9}), ("Async", {})]


@pytest.mark.parametrize("cls,kw", POLICIES,
                         ids=[f"{c}{kw}" for c, kw in POLICIES])
@pytest.mark.parametrize("stale", [NO_STALE, {0: 0, 1: 0, 2: 0, 3: 2}])
def test_policy_plans_identical(cls, kw, stale):
    plan = both(lambda fl, *_: _as_plain(
        getattr(fl, cls)(**kw).plan(COMPLETIONS, stale)))
    assert sorted(plan["participants"] + plan["carried"]
                  + plan["cancelled"]) == [0, 1, 2, 3]


def test_policy_claims_hold_on_the_port():
    plan = FullSync().plan(COMPLETIONS, NO_STALE)
    assert plan.commit_time == 40.0 and plan.participants == [0, 1, 2, 3]
    plan = BackupWorkers(drop_frac=0.25).plan(COMPLETIONS, NO_STALE)
    assert plan.commit_time == 12.0 and plan.cancelled == [3]
    pol = BoundedStaleness(bound=2, quorum_frac=0.5)
    assert pol.plan(COMPLETIONS, NO_STALE).carried == [2, 3]
    assert pol.plan(COMPLETIONS, {0: 0, 1: 0, 2: 0, 3: 2}).commit_time == 40
    assert SemiSync(k=2).plan(COMPLETIONS, NO_STALE).commit_time == 11.0
    plan = Async().plan({0: 5.0, 1: 5.0, 2: 9.0}, {})
    assert plan.participants == [0, 1] and plan.carried == [2]
    with pytest.raises(ValueError):
        make_policy(FleetConfig(policy="gossip"))
    with pytest.raises(ValueError):
        BackupWorkers(drop_frac=1.0)
    with pytest.raises(ValueError):
        SemiSync(k=0)
    assert isinstance(make_policy(FleetConfig(policy="semi-sync",
                                              semi_sync_k=3)), SemiSync)


# ---------------------------------------------------------------------------
# engine


def _engine_run(fl, ccfg, clock, fleet_kw, n, rounds, waits_hi=0.0,
                floats=1e6, seed=0):
    base = ccfg(n_devices=n, grad_floats=floats)
    eng = fl.FleetEngine(fl.FleetConfig(**fleet_kw), base)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        act = eng.active_mask()
        res = eng.round(waits=rng.uniform(0.0, waits_hi, n),
                        batches=rng.integers(8, 128, n).astype(float) * act,
                        floats_on_wire=floats, extra_bytes=1e5)
        out.append(_as_plain(res))
    return out, _as_plain(eng.summary()), eng.time_s


ENGINE_CASES = [
    ({"profile": "k80-uniform"}, 16),
    ({"profile": "jetson-mixed", "policy": "backup-workers",
      "drop_frac": 0.25}, 8),
    ({"profile": "jetson-mixed", "policy": "bounded-staleness",
      "staleness_bound": 2, "quorum_frac": 0.5}, 8),
    ({"profile": "jetson-mixed", "policy": "semi-sync", "semi_sync_k": 3}, 8),
    ({"profile": "jetson-mixed", "policy": "async"}, 8),
    ({"profile": "phone-flaky", "policy": "backup-workers", "churn": True,
      "drop_frac": 0.25}, 6),
    ({"profile": "phone-flaky", "policy": "async", "churn": True}, 6),
    ({"profile": "jetson-mixed", "compute_model": "per-device"}, 8),
]


@pytest.mark.parametrize("fleet_kw,n", ENGINE_CASES,
                         ids=[f"{kw['profile']}-{kw.get('policy', 'full')}"
                              f"{'-churn' if kw.get('churn') else ''}"
                              f"{'-perdev' if 'compute_model' in kw else ''}"
                              for kw, _ in ENGINE_CASES])
def test_engine_identical(fleet_kw, n):
    rounds, summary, _ = both(
        lambda *pkg: _engine_run(*pkg, fleet_kw, n, 25, waits_hi=2.0))
    assert summary["fleet_rounds"] == 25


@pytest.mark.parametrize("bandwidth_gbps", [5.0, 1.0])
def test_homogeneous_full_sync_matches_edgeclock(bandwidth_gbps):
    base = EdgeClockConfig(n_devices=16, grad_floats=60.2e6,
                           bandwidth_gbps=bandwidth_gbps)
    eng = FleetEngine(FleetConfig(profile="k80-uniform"), base)
    clk = EdgeClock(base)
    rng = np.random.default_rng(0)
    for _ in range(25):
        waits = rng.uniform(0.0, 3.0, 16)
        batches = rng.integers(8, 128, 16).astype(float)
        res = eng.round(waits=waits, batches=batches,
                        floats_on_wire=60.2e6, extra_bytes=2e6)
        dt = clk.step(wait_s=float(waits.max()),
                      local_batch=float(batches.mean()),
                      floats_on_wire=60.2e6, extra_bytes=2e6)
        assert res.dt == pytest.approx(dt, rel=1e-9)
        assert res.part.all() and res.started.all()


def test_engine_claims_hold_on_the_port():
    profs = [DeviceProfile(f"d{i}", compute_mult=m)
             for i, m in enumerate([1.0, 3.0])]
    eng = FleetEngine(FleetConfig(profile=profs, policy="async"),
                      EdgeClockConfig(n_devices=2, grad_floats=1e6))
    slow_stale = []
    for r in range(8):
        act = eng.active_mask()
        res = eng.round(waits=np.zeros(2), batches=np.full(2, 64.0) * act,
                        floats_on_wire=1e6)
        assert res.version == r + 1 == eng.version
        assert res.part.sum() == 1
        assert (res.staleness[~res.part] == -1).all()
        if res.part[1]:
            slow_stale.append(int(res.staleness[1]))
    assert slow_stale and min(slow_stale) >= 1
    # max_wait covers committed fresh starters only
    profs = [DeviceProfile("a"), DeviceProfile("b")]
    base = EdgeClockConfig(n_devices=2, grad_floats=1e6)
    bk = FleetEngine(FleetConfig(profile=profs, policy="backup-workers",
                                 drop_frac=0.5), base)
    res = bk.round(waits=np.array([0.5, 50.0]), batches=np.full(2, 64.0),
                   floats_on_wire=1e6)
    assert res.dropped == [1] and res.max_wait == pytest.approx(0.5)
    # heterogeneous links: the slowest bounds a full-sync round
    profs = [DeviceProfile("fast", bandwidth_gbps=5.0),
             DeviceProfile("slow", bandwidth_gbps=0.5)]
    eng = FleetEngine(FleetConfig(profile=profs),
                      EdgeClockConfig(n_devices=2, grad_floats=60.2e6))
    res = eng.round(waits=np.zeros(2), batches=np.full(2, 64.0),
                    floats_on_wire=60.2e6)
    assert res.dt > 9 * eng.device_comm_time(0, 60.2e6)


def test_engine_live_policy_switch_identical():
    def run(fl, ccfg, _):
        eng = fl.FleetEngine(fl.FleetConfig(profile="jetson-mixed",
                                            policy="async"),
                             ccfg(n_devices=8, grad_floats=1e6))
        out = []
        for r in range(18):
            if r == 6:
                eng.set_policy("semi-sync", semi_sync_k=3)
            if r == 10:
                eng.reconfigure(semi_sync_k=5)
            if r == 13:
                eng.set_policy("backup-workers", drop_frac=0.25)
            act = eng.active_mask()
            res = eng.round(waits=np.zeros(8), batches=np.full(8, 64.0) * act,
                            floats_on_wire=1e6)
            out.append((_as_plain(res), eng.policy.name, eng.policy.knobs()))
        return out, _as_plain(eng.telemetry_summary())
    out, _ = both(run)
    assert [name for _, name, _ in out][-1] == "backup-workers"


def test_hill_climb_controller_identical():
    def run(fl, ccfg, _):
        eng = fl.FleetEngine(fl.FleetConfig(profile="jetson-mixed",
                                            controller="hill-climb",
                                            controller_window=1),
                             ccfg(n_devices=8, grad_floats=1e6))
        out, loss = [], 2.3
        for _ in range(60):
            act = eng.active_mask()
            res = eng.round(waits=np.zeros(8), batches=np.full(8, 64.0) * act,
                            floats_on_wire=1e6)
            loss *= 0.99
            action = eng.controller_update(loss)
            out.append((_as_plain(res), eng.policy.name, eng.policy.knobs(),
                        None if action is None else action.reason))
        return out
    out = both(run)
    assert any(reason is not None for *_, reason in out)


# ---------------------------------------------------------------------------
# the trainer's fleet paths


@pytest.fixture(scope="module")
def fleet_data():
    kw = dict(num_classes=10, train_per_class=48, test_per_class=8,
              noise=0.8, seed=0)
    return JData(**kw), ClassClusterData(**kw)


def _port_trainer(data, n, fleet=None, **kw):
    cfg = dict(n_devices=n, dist="S1", weighted=True, b_max=64,
               grad_floats=60.2e6)
    cfg.update(kw)
    return ScaDLESTrainer(make_mlp(hidden=32),
                          DeviceDataSource(data, n, iid=True),
                          ScaDLESConfig(fleet=fleet, device="cpu", **cfg))


@pytest.mark.parametrize("policy,kw", [("full-sync", {}),
                                       ("semi-sync", {"semi_sync_k": 2}),
                                       ("async", {})])
def test_k80_uniform_matches_legacy_clock(fleet_data, policy, kw):
    """Zero-wait arrivals tie on a homogeneous fleet, so relaxed commits
    group the whole fleet: every policy reproduces the legacy clock."""
    _, data = fleet_data
    legacy = _port_trainer(data, 8)
    fleet = _port_trainer(data, 8, FleetConfig(profile="k80-uniform",
                                               policy=policy, **kw))
    legacy.run(8)
    fleet.run(8)
    assert fleet.sim_time_s == pytest.approx(legacy.sim_time_s, rel=1e-9)
    for h_l, h_f in zip(legacy.history, fleet.history):
        assert h_f["sim_time_s"] == pytest.approx(h_l["sim_time_s"],
                                                  rel=1e-9)
        assert h_f["loss"] == pytest.approx(h_l["loss"], rel=1e-4, abs=1e-5)
        assert h_f["mean_stale"] == 0.0
    assert fleet.summary()["fleet_max_staleness"] == 0.0


@pytest.mark.parametrize("policy,kw", [("async", {}),
                                       ("semi-sync", {"semi_sync_k": 4})])
def test_relaxed_policies_commit_stale_gradients(fleet_data, policy, kw):
    _, data = fleet_data
    tr = _port_trainer(data, 8, FleetConfig(profile="jetson-mixed",
                                            policy=policy, **kw))
    tr.run(24)
    s = tr.summary()
    assert s["fleet_version"] == 24
    assert s["fleet_part_rate"] < 1.0
    assert s["fleet_mean_staleness"] > 0
    assert np.isfinite(tr.history[-1]["loss"])
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


@pytest.fixture(scope="module")
def small_data():
    return ClassClusterData(num_classes=10, train_per_class=24,
                            test_per_class=4, noise=0.8, seed=0)


def test_refunds_buffer_of_dropped_straggler(small_data):
    profs = [DeviceProfile(f"d{i}", compute_mult=m)
             for i, m in enumerate([1.0, 1.0, 1.0, 10.0])]
    tr = _port_trainer(small_data, 4, FleetConfig(
        profile=profs, policy="backup-workers", drop_frac=0.25))
    tr.run(6)
    assert sum(h["n_dropped"] for h in tr.history) == 6
    b = tr.buffers[3]
    assert b.total_consumed == pytest.approx(0.0)
    assert b.size == pytest.approx(b.total_streamed)
    assert all(tr.buffers[i].total_consumed > 0 for i in range(3))


def test_refunds_ring_evicted_commits_and_consumes_pending_once(small_data):
    profs = [DeviceProfile("fast"), DeviceProfile("slow", compute_mult=3.0)]
    tr = _port_trainer(small_data, 2, FleetConfig(profile=profs,
                                                  policy="async"),
                       param_ring=1)
    tr.run(10)
    slow = tr.buffers[1]
    assert slow.total_consumed == pytest.approx(0.0)
    assert slow.size == pytest.approx(slow.total_streamed)
    assert tr.buffers[0].total_consumed > 0
    for i in np.flatnonzero(tr._pending_valid):
        assert i in tr.fleet.busy_until
    assert len(tr._param_ring) == 1


def test_buffer_conservation_under_backup_workers_with_churn(small_data):
    tr = _port_trainer(small_data, 6, FleetConfig(
        profile="phone-flaky", policy="backup-workers", drop_frac=0.25,
        churn=True))
    tr.run(12)
    assert sum(h["n_dropped"] + h["n_crashed"] for h in tr.history) > 0
    for b in tr.buffers:
        assert b.total_consumed >= -1e-9
        assert b.size == pytest.approx(
            b.total_streamed - b.total_consumed - b.total_dropped, abs=1e-6)


def _run_both_fleet(fleet_data, steps, fleet_kw, switch=None, **kw):
    jdata, tdata = fleet_data
    n = kw.pop("n_devices", 8)
    cfg = {**dict(n_devices=n, dist="S1", weighted=True, b_max=48,
                  grad_floats=60.2e6), **kw}
    jm = jax_mlp()
    ref = JTrainer(jm, JSource(jdata, n, iid=True),
                   JConfig(fleet=jfleet.FleetConfig(**fleet_kw), **cfg))
    port = ScaDLESTrainer(port_model_from(ref.params),
                          DeviceDataSource(tdata, n, iid=True),
                          ScaDLESConfig(fleet=FleetConfig(**fleet_kw),
                                        device="cpu", **cfg))
    for tr in (ref, port):
        if switch is None:
            tr.run(steps)
        else:
            tr.run(steps // 2)
            switch(tr)
            tr.run(steps - steps // 2)
    return ref, port


def _assert_same(ref, port):
    assert len(ref.history) == len(port.history)
    for r, p in zip(ref.history, port.history):
        assert set(r) == set(p)
        for key in r:
            if key not in ("loss", "gap"):
                assert p[key] == r[key], (key, r["step"])
        assert abs(p["loss"] - r["loss"]) <= (LOSS_RTOL * abs(r["loss"])
                                              + LOSS_ATOL), r["step"]
    assert port.summary() == pytest.approx(ref.summary(), rel=1e-12)


@pytest.mark.parametrize("fleet_kw,kw", [
    ({"profile": "jetson-mixed", "policy": "async"}, {}),
    ({"profile": "jetson-mixed", "policy": "semi-sync", "semi_sync_k": 4},
     {}),
    ({"profile": "jetson-mixed", "policy": "bounded-staleness",
      "staleness_bound": 2}, {"weighted": False}),
    ({"profile": "phone-flaky", "policy": "async", "churn": True},
     {"injection": (0.5, 0.25)}),
    ({"profile": "jetson-mixed", "policy": "backup-workers",
      "churn": True}, {"local_steps": 2}),
], ids=["jetson-async", "jetson-semi-sync-4", "jetson-bounded-ddl",
        "phone-async-churn-injection", "jetson-backup-churn-local2"])
def test_fleet_history_matches_reference(fleet_data, fleet_kw, kw):
    ref, port = _run_both_fleet(fleet_data, 20, fleet_kw, **kw)
    _assert_same(ref, port)
    assert any(h["n_part"] < 8 for h in port.history)


def test_live_switch_and_controller_match_reference(fleet_data):
    ref, port = _run_both_fleet(
        fleet_data, 20, {"profile": "jetson-mixed", "policy": "async"},
        switch=lambda tr: tr.set_sync_policy("backup-workers",
                                             drop_frac=0.25))
    _assert_same(ref, port)
    assert port.history[-1]["policy"] == "backup-workers"
    assert not port._pending_valid.any()
    ref, port = _run_both_fleet(
        fleet_data, 24, {"profile": "jetson-mixed",
                         "controller": "hill-climb", "controller_window": 1})
    _assert_same(ref, port)
    with pytest.raises(ValueError):
        _port_trainer(fleet_data[1], 2).set_sync_policy("async")


def test_compressed_async_matches_reference(fleet_data):
    """The carry path replays each committer's start-round compression
    decision (a per-device flag); top-k's boundary makes the loss bound
    that of a compressed run, so only the host fields are held exactly."""
    ref, port = _run_both_fleet(fleet_data, 20,
                                {"profile": "jetson-mixed",
                                 "policy": "async"},
                                compression=(0.1, 0.3))
    for r, p in zip(ref.history, port.history):
        for key in r:
            if key not in ("loss", "gap"):
                assert p[key] == r[key], (key, r["step"])
        assert p["loss"] == pytest.approx(r["loss"], rel=1e-3)
    assert 0 < port.summary()["cnc_ratio"] <= 1


# ---------------------------------------------------------------------------
# observability


def test_tracked_fleet_run_is_bit_exact_and_emits_rounds(fleet_data):
    _, data = fleet_data
    jp = jax_mlp()["init"](jax.random.PRNGKey(0))
    runs = []
    for tracker in (MemoryTracker(), None):
        tr = ScaDLESTrainer(port_model_from(jp),
                            DeviceDataSource(data, 8, iid=True),
                            ScaDLESConfig(n_devices=8, b_max=64,
                                          grad_floats=60.2e6, device="cpu",
                                          tracker=tracker,
                                          fleet=FleetConfig(
                                              profile="jetson-mixed",
                                              policy="async")))
        tr.run(5)
        runs.append(tr)
    tracked, plain = runs
    mt = tracked.tracker
    rounds = [r["data"] for r in mt.of_kind(TRAIN_ROUND)]
    assert len(rounds) == 5 and len(mt.of_kind(FLEET_ROUND)) == 5
    assert all(r["step_flops"] > 0 for r in rounds)
    assert all(math.isfinite(r["mfu"]) and r["mfu"] > 0 for r in rounds)
    fr0 = mt.of_kind(FLEET_ROUND)[0]["data"]
    assert fr0["policy"] == "async" and fr0["n_participants"] >= 1
    for h_t, h_p in zip(tracked.history, plain.history):
        assert h_t == h_p
    for key in tracked.params:
        assert torch.equal(tracked.params[key], plain.params[key])
    assert plain._obs._flops_cache == {}

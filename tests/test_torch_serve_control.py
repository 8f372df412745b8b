"""The port's serving controller (``serve/control.py``) against the
reference, on the CPU.

* Both packages' pure-sim ``Scheduler`` with a ``ServeController`` on the
  bursty trace of ``tests/test_serve_scale.py`` take identical actions
  (t, axis, value, reason) and give identical summaries and records, over
  runner counts, start knobs and controller settings; the reference's
  claims on that trace (goodput within 5 % of the best static knob
  setting, every action on its axis) hold on the port.
* The ``ClimbCore`` tie and revert cases of ``tests/test_serve_scale.py``
  on the port's core, and the same objective scripts driven through each
  package's controller by a stand-in scheduler: identical actions, and
  every axis's core sees every objective sample.
"""
import dataclasses
import math

import pytest

import repro.serve as jserve
from repro.fleet import control as jfleet_control
from repro_torch import serve as tserve
from repro_torch.fleet import control as tfleet_control

PKGS = {"ref": (jserve, jfleet_control), "port": (tserve, tfleet_control)}
# the reference's stress cost model (tests/test_serve_scale.py)
COST_KW = dict(decode_step_s=0.01, prefill_token_s=5e-4, prefill_base_s=2e-3)
BURSTY = dict(base_rate=30.0, burst_mult=4.0, prompt_lens=(16, 64, 256),
              max_new_tokens=16, slo_ttft_s=0.25, slo_tpot_s=0.05, seed=1)
HORIZON = 8.0


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN, through dicts, lists and tuples."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def _controlled(pkg, sched_kw, ctrl_kw, control_every_s=1.0, window_s=1.0):
    reqs = pkg.BurstyRequestStream(**BURSTY).generate(HORIZON)
    ctrl = pkg.ServeController(**ctrl_kw)
    sched = pkg.Scheduler(4, pkg.StepCostModel(**COST_KW), **sched_kw)
    recs, summary = sched.run(reqs, horizon_s=HORIZON, controller=ctrl,
                              control_every_s=control_every_s,
                              window_s=window_s)
    actions = [dataclasses.astuple(a) for a in ctrl.actions]
    rows = [dataclasses.astuple(r) for r in recs]
    return ctrl, sched, actions, summary, rows


CASES = [
    (dict(n_runners=4), {}, 1.0),
    (dict(n_runners=1), {}, 1.0),
    (dict(n_runners=4, chunk_tokens=64, priority="prefill_first"), {}, 1.0),
    (dict(n_runners=2, chunk_tokens=48), {}, 1.0),          # off the grid
    (dict(n_runners=4), dict(tol=0.02, probe_every=1, warm_ticks=0), 0.5),
    (dict(n_runners=3), dict(chunk_grid=(32, 128, None)), 1.0),
]


@pytest.mark.parametrize("sched_kw,ctrl_kw,every", CASES,
                         ids=["4-runners", "1-runner", "prefill-first-64",
                              "off-grid", "eager", "short-grid"])
def test_controlled_schedule_identical(sched_kw, ctrl_kw, every):
    out = {}
    for name, (pkg, _) in PKGS.items():
        ctrl, sched, actions, summary, rows = _controlled(
            pkg, sched_kw, ctrl_kw, control_every_s=every, window_s=every)
        assert summary["conservation_ok"]
        out[name] = (actions, summary, rows, sched.chunk_tokens,
                     sched.priority, sched.active_runners)
    assert out["port"][0], "the controller took no action"
    assert _same(out["port"], out["ref"])
    ctrl = _controlled(tserve, sched_kw, ctrl_kw, every, every)[0]
    grid = set(ctrl.chunk_grid)
    for a in ctrl.actions:
        if a.axis == "chunk_tokens":
            assert a.value in grid
        elif a.axis == "priority":
            assert a.value in tserve.PRIORITIES
        else:
            assert 1 <= a.value <= sched_kw["n_runners"]


def test_port_controller_tracks_best_static():
    """``tests/test_serve_scale.py::test_serve_controller_tracks_best_static``
    on the port."""
    reqs = tserve.BurstyRequestStream(**BURSTY).generate(HORIZON)
    cost = tserve.StepCostModel(**COST_KW)
    best = 0.0
    for c in (None, 64):
        for p in tserve.PRIORITIES:
            for n in (1, 4):
                _, s = tserve.Scheduler(4, cost, n_runners=n, chunk_tokens=c,
                                        priority=p).run(reqs,
                                                        horizon_s=HORIZON)
                best = max(best, s["goodput_tok_s"])
    ctrl = tserve.ServeController()
    _, cs = tserve.Scheduler(4, cost, n_runners=4).run(
        reqs, horizon_s=HORIZON, controller=ctrl, control_every_s=1.0,
        window_s=1.0)
    assert cs["conservation_ok"]
    assert cs["goodput_tok_s"] >= 0.95 * best
    assert len(ctrl.actions) > 0


def test_empty_chunk_grid_refused():
    for pkg, _ in PKGS.values():
        with pytest.raises(ValueError):
            pkg.ServeController(chunk_grid=())


# ---------------------------------------------------------------------------
# the climb core, alone and through the controller

# (core args, objective script, expected moves) from tests/test_serve_scale.py
CLIMBS = {
    "relax-tie-and-revert": (
        (0, 10, 5), [1.0, 1.0, 1.0, 1.0, 0.3, 1.0],
        [(4, "probe"), (5, "confirm"), (4, "accept"), (2, "probe"),
         (4, "confirm"), None]),
    "tighten-needs-proof": (
        (0, 10, 0), [1.0, 1.0, 1.0],
        [(1, "probe"), (0, "confirm"), None]),
}


@pytest.mark.parametrize("case", sorted(CLIMBS))
def test_climbcore_cases_on_the_port(case):
    args, script, want = CLIMBS[case]
    cores = [mod.ClimbCore(*args, tol=0.05, probe_every=2, relax_dir=-1)
             for mod in (tfleet_control, jfleet_control)]
    for obj, move in zip(script, want):
        got = [core.observe(obj) for core in cores]
        assert got[0] == got[1] == move
    port, ref = cores
    assert (port.ref, port.step, port.direction, port.phase) == \
        (ref.ref, ref.step, ref.direction, ref.phase)
    if case == "relax-tie-and-revert":
        assert port.ref == 4 and port.step == 1 and port.direction == 1
    else:
        assert port.ref == 0


class _Window:
    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def goodput(self, now):
        obj = self.script[self.calls % len(self.script)]
        self.calls += 1
        return obj


class _StandIn:
    """The knobs a ``ServeController`` reads and sets, with a scripted
    goodput window in place of a run."""

    def __init__(self, pkg, script, n_runners=4, chunk_tokens=64,
                 priority="decode_first"):
        self.PRIORITIES = pkg.PRIORITIES
        self.n_runners = n_runners
        self.active_runners = n_runners
        self.chunk_tokens = chunk_tokens
        self.priority = priority
        self.window = _Window(script)
        self.log = []

    def set_chunk_tokens(self, v):
        self.chunk_tokens = v
        self.log.append(("chunk_tokens", v))

    def set_priority(self, v):
        assert v in self.PRIORITIES
        self.priority = v
        self.log.append(("priority", v))

    def set_active_runners(self, v):
        assert 1 <= v <= self.n_runners
        self.active_runners = v
        self.log.append(("active_runners", v))


@pytest.mark.parametrize("case", sorted(CLIMBS))
@pytest.mark.parametrize("n_runners", [1, 4])
def test_climb_scripts_through_the_controller(case, n_runners):
    """Each package's controller, driven by the same objective script, takes
    the same actions on the same knobs, and every axis's core has seen
    every sample (``note_scale``), the one-runner axis included."""
    _, script, _ = CLIMBS[case]
    ticks = 4 * len(script)
    out = {}
    for name, (pkg, _) in PKGS.items():
        ctrl = pkg.ServeController(tol=0.05, probe_every=2, warm_ticks=1)
        sched = _StandIn(pkg, script, n_runners=n_runners)
        acts = [ctrl.tick(0.5 * i, sched) for i in range(ticks)]
        out[name] = ([dataclasses.astuple(a) for a in acts if a is not None],
                     sched.log, (sched.chunk_tokens, sched.priority,
                                 sched.active_runners),
                     [(ax.name, ax.core.ref, ax.core.phase, ax.core.step,
                       ax.core.trend, ax.core.max_obj)
                      for ax in ctrl._axes])
        assert len(ctrl.actions) == len(out[name][0])
        # every core saw every sample, the live axis's and the others'
        assert all(ax.core.max_obj == max(script) for ax in ctrl._axes)
    assert out["port"] == out["ref"]
    assert out["port"][0], "the scripted objective moved no knob"

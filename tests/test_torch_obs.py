"""The port's ``obs/regress.py`` and ``obs/profile.py``, on the CPU.

regress: the reference's gate cases (``tests/test_obs.py``: the band edges
of ``MetricSpec.classify``, ``compare`` with its exit semantics, the
baseline round trip) run on both packages; every case's outcome, reports
included, must be equal as JSON, and equal to what the reference's tests
assert.  ``load_baseline`` of the committed ``BENCH_scadles.json`` (read
only) gives equal specs in both.  profile: ``capture`` records and writes a
Chrome trace on the CPU; it yields False, and still runs its body, when
disabled, without a ``logdir``, or when the profiler cannot start; a
body's exception propagates; ``capture_step`` returns None when capture is
skipped.
"""
import contextlib
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.obs import regress as jreg  # noqa: E402
from repro_torch.obs import profile as tprof  # noqa: E402
from repro_torch.obs import regress as treg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _classify_edges(reg, tmp):
    hi = reg.MetricSpec(value=100.0, tol_frac=0.10, direction="higher")
    lo = reg.MetricSpec(value=10.0, tol_frac=0.10, direction="lower")
    two = reg.MetricSpec(value=50.0, tol_frac=0.0, abs_tol=1.0,
                         direction="two-sided")
    out = {"hi": [hi.classify(v) for v in (None, 89.0, 90.0, 100.0, 111.0)],
           "lo": [lo.classify(v) for v in (11.5, 11.0, 8.0)],
           "two": [two.classify(v) for v in (50.9, 51.1, 48.9)],
           "worst": [s.worst_allowed() for s in (hi, lo, two)],
           "dicts": [s.to_dict() for s in (hi, lo, two)]}
    for bad in ({"direction": "sideways"}, {"tol_frac": -0.1}):
        try:
            reg.MetricSpec(value=1.0, **bad)
        except ValueError as e:
            out.setdefault("refused", []).append(str(e))
    return out


def _compare_and_exit(reg, tmp):
    baseline = {"good": reg.MetricSpec(value=100.0, direction="higher"),
                "bad": reg.MetricSpec(value=100.0, direction="higher"),
                "gone": reg.MetricSpec(value=1.0, direction="lower")}
    report = reg.compare(baseline, {"good": 101.0, "bad": 50.0,
                                    "fresh": 3.0})
    ok = reg.compare(baseline, {"good": 100.0, "bad": 95.0, "gone": 1.0})
    path = tmp / "report.json"
    reg.write_report(str(path), report, baseline_path="base.json")
    written = json.loads(path.read_text())
    return {"report": report.to_dict(), "ok": ok.to_dict(),
            "failures": sorted(report.failures), "table": report.format_table(),
            "ok_table": ok.format_table(),
            "written": {k: written[k] for k in ("baseline", "ok", "counts",
                                                "rows")}}


def _baseline_roundtrip(reg, tmp):
    path = tmp / "base.json"
    specs = {"m1": reg.MetricSpec(value=2.5, tol_frac=0.2, direction="lower",
                                  note="n"),
             "m2": reg.MetricSpec(value=7.0, abs_tol=0.5,
                                  direction="two-sided")}
    reg.save_baseline(str(path), specs, seed=0, meta={"gate": "test"})
    meta, loaded = reg.load_baseline(str(path))
    assert loaded == specs
    other = tmp / "notbase.json"
    other.write_text(json.dumps({"rows": []}))
    with pytest.raises(ValueError):
        reg.load_baseline(str(other))
    return {"specs": {k: v.to_dict() for k, v in loaded.items()},
            "seed": meta["run"]["seed"], "meta_keys": sorted(meta)}


EXPECTED = {
    "classify_edges": lambda out: (
        out["hi"] == ["missing_current", "regressed", "pass", "pass",
                      "improved"]
        and out["lo"] == ["regressed", "pass", "improved"]
        and out["two"] == ["pass", "regressed", "regressed"]
        and len(out["refused"]) == 2),
    "compare_and_exit": lambda out: (
        not out["report"]["ok"] and out["failures"] == ["bad", "gone"]
        and out["report"]["rows"]["fresh"]["status"] == "new"
        and out["report"]["counts"]["regressed"] == 1
        and out["report"]["counts"]["missing_current"] == 1
        and "FAIL" in out["table"] and out["ok"]["ok"]),
    "baseline_roundtrip": lambda out: out["seed"] == 0,
}
CASES = {"classify_edges": _classify_edges,
         "compare_and_exit": _compare_and_exit,
         "baseline_roundtrip": _baseline_roundtrip}


@pytest.mark.parametrize("case", sorted(CASES))
def test_regress_cases_match_reference(case, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jout = CASES[case](jreg, tmp_path / "j")
    tout = CASES[case](treg, tmp_path / "t")
    assert json.dumps(tout, sort_keys=True) == json.dumps(jout,
                                                          sort_keys=True)
    assert EXPECTED[case](tout)


def test_load_committed_baseline_matches_reference():
    path = str(ROOT / "BENCH_scadles.json")
    jmeta, jspecs = jreg.load_baseline(path)
    tmeta, tspecs = treg.load_baseline(path)
    assert jspecs and tmeta == jmeta
    assert {k: v.to_dict() for k, v in tspecs.items()} == {
        k: v.to_dict() for k, v in jspecs.items()}


# ---------------------------------------------------------------------------
# profile


def test_capture_records_and_writes_a_trace(tmp_path):
    assert tprof.profiler_available()
    ran = []
    with tprof.capture(str(tmp_path / "trace")) as recording:
        ran.append(float(torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()))
    assert recording and ran == [64.0 * 64 * 64]
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


@pytest.mark.parametrize("how", ["disabled", "no logdir", "cannot start"])
def test_capture_is_a_noop_when_it_cannot_record(how, tmp_path,
                                                  monkeypatch):
    def refuse(*args, **kw):
        raise RuntimeError("profiler already running")

    if how == "cannot start":
        monkeypatch.setattr(torch.profiler, "profile", refuse)
    logdir = None if how == "no logdir" else str(tmp_path / "t")
    ran = []
    with pytest.warns(RuntimeWarning) if how == "cannot start" else \
            contextlib.nullcontext():
        with tprof.capture(logdir, enabled=how != "disabled") as recording:
            ran.append(1)
    assert recording is False and ran == [1]
    assert not list(tmp_path.rglob("trace_*.json"))
    calls = []
    assert tprof.capture_step(lambda x: calls.append(x) or x, (3,),
                              logdir if how != "disabled" else None,
                              reps=2) is None
    assert calls == [3, 3, 3]


def test_capture_propagates_the_body_exception(tmp_path):
    with pytest.raises(KeyError, match="from the body"):
        with tprof.capture(str(tmp_path)) as recording:
            assert recording
            raise KeyError("from the body")
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


def test_capture_step_records_the_window(tmp_path):
    calls = []

    def fn(x):
        calls.append(x)
        return torch.full((4,), float(x))

    assert tprof.capture_step(fn, (2,), str(tmp_path), reps=3) == str(
        tmp_path)
    assert calls == [2, 2, 2, 2]
    assert len(list(tmp_path.glob("trace_*.json"))) == 1

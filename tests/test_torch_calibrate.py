"""``repro_torch.dist.calibrate`` against ``repro.dist.calibrate``.

The dataclasses and the ring formula are carried over unchanged, so they
must agree exactly; the fleet engine takes either calibration.  The port's
``calibrate`` records the two DDP programs on a fake process group where
the reference lowers them for host devices: both run live into
``tmp_path`` and must give the same calibration, wire bytes exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.dist import calibrate as ref
from repro_torch.core.simclock import EdgeClock, EdgeClockConfig
from repro_torch.dist import calibrate as port
from repro_torch.fleet import FleetConfig, FleetEngine


def _pair(**kw):
    return port.CommCalibration(**kw), ref.CommCalibration(**kw)


def test_ring_formula_matches_reference():
    for n in range(0, 17):
        for floats in (0.0, 1.0, 2.5e6, 1575680.0):
            assert (port.ring_wire_bytes(n, floats)
                    == ref.ring_wire_bytes(n, floats))
            assert (port.AnalyticRingModel(n).bytes_for(floats)
                    == ref.AnalyticRingModel(n).bytes_for(floats))


def test_comm_calibration_matches_reference():
    mine, theirs = _pair(n_devices=8, n_floats=1000, k=50,
                         dense_wire_bytes=7000.0,
                         compressed_wire_bytes=700.0, arch="x")
    for floats in np.linspace(0.0, 3000.0, 61):
        assert mine.bytes_for(floats) == theirs.bytes_for(floats)
    assert mine.to_dict() == theirs.to_dict()
    assert port.CommCalibration.from_dict(mine.to_dict()) == mine
    assert port.CommCalibration.from_dict(
        dict(theirs.to_dict(), extra=1)) == mine
    assert ([f.name for f in dataclasses.fields(port.CommCalibration)]
            == [f.name for f in dataclasses.fields(ref.CommCalibration)])
    for args in (("a", 4, 0.1, True), ("a/b", 8, 0.25, False)):
        assert (port._cache_path(*args, "d")
                == ref._cache_path(*args, "d"))


def _run_rounds(engine, n, rounds=5, floats=2.5e6):
    return [engine.round(waits=np.zeros(n), batches=np.full(n, 64.0),
                         floats_on_wire=floats, extra_bytes=128.0).dt
            for _ in range(rounds)]


def test_analytic_model_reproduces_legacy_engine():
    base = EdgeClockConfig(n_devices=4)
    legacy = FleetEngine(FleetConfig(), base)
    wrapped = FleetEngine(FleetConfig(comm_model=port.AnalyticRingModel(4)),
                          base)
    assert _run_rounds(legacy, 4) == _run_rounds(wrapped, 4)
    clock = EdgeClock(EdgeClockConfig(n_devices=4))
    dt_clock = clock.step(wait_s=0.0, local_batch=64.0, floats_on_wire=2.5e6,
                          extra_bytes=128.0)
    assert _run_rounds(FleetEngine(FleetConfig(), base), 4, rounds=1)[0] \
        == pytest.approx(dt_clock, rel=1e-9)


def test_calibrated_engine_charges_calibration_bytes():
    n, n_floats, k = 4, 1_000_000, 10_000
    dense_b = port.ring_wire_bytes(n, n_floats) * 0.9
    comp_b = 6.0 * k * (n - 1)
    cal = port.CommCalibration(n_devices=n, n_floats=n_floats, k=k,
                               dense_wire_bytes=dense_b,
                               compressed_wire_bytes=comp_b)
    base = EdgeClockConfig(n_devices=n)
    eng = FleetEngine(FleetConfig(comm_model=cal), base)
    eff_bw = base.bandwidth_gbps * 1e9 / 8 * base.bandwidth_efficiency
    assert eng.device_comm_time(0, n_floats) == pytest.approx(dense_b / eff_bw)
    assert eng.device_comm_time(0, 2 * k) == pytest.approx(comp_b / eff_bw)
    with pytest.raises(ValueError, match="calibrated for 4"):
        FleetEngine(FleetConfig(comm_model=cal), EdgeClockConfig(n_devices=8))


def test_calibrate_matches_reference(tmp_path):
    """Both packages live at (2 devices, cr 0.25): the same fields, the
    wire bytes exactly (6 302 728 dense, 3 151 372 compressed); the second
    call of each reads its cache."""
    mine = port.calibrate("qwen1.5-0.5b", 2, 0.25,
                          cache_dir=str(tmp_path / "port"))
    theirs = ref.calibrate("qwen1.5-0.5b", 2, 0.25,
                           cache_dir=str(tmp_path / "ref"))
    assert mine.to_dict() == theirs.to_dict()
    assert (mine.n_floats, mine.k) == (1_575_680, 393_920)
    assert (mine.dense_wire_bytes, mine.compressed_wire_bytes) == (
        6_302_728.0, 3_151_372.0)
    assert port.calibrate("qwen1.5-0.5b", 2, 0.25,
                          cache_dir=str(tmp_path / "port")) == mine
    fleet = port.calibrated_fleet_config(
        FleetConfig(), cr=0.25, n_devices=2,
        cache_dir=str(tmp_path / "port"))
    assert fleet.comm_model == mine

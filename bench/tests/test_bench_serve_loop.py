"""The serving loop at a tiny size on the CPU, on a clock that moves one
unit a reading, so that a run repeats exactly: where its window ends, and
how many requests the reference compares."""
import time

import pytest

from bench import harness
from bench.reference import serve as serve_ref
from bench.tests.tiny import tiny_cell

CELL = "mixtral-8x22b.serve_decode"


class _Clock:
    """``perf_counter`` one unit later at each reading; ``time`` real."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0
        return self.now

    @staticmethod
    def time():
        return time.time()


def _run(monkeypatch, seconds, **wl_extra):
    """(result, record, events) of a run on the unit clock; events, in
    order: ("admit", its start, its first token's time) and ("step", its
    tokens' time, active slots, slots it freed)."""
    drv = harness.load_module("drivers", "serve_closed")
    clock = _Clock()
    monkeypatch.setattr(drv, "time", clock)
    events, records = [], []
    admit, step, run = drv.Loop.admit, drv.Loop.step, drv.run

    def logged_admit(self, slot):
        # an admission reads the clock twice: at its start and at its end
        events.append(("admit", clock.now + 1, clock.now + 2))
        admit(self, slot)

    def logged_step(self):
        active = len(self.slots)
        freed = step(self)
        events.append(("step", clock.now, active, len(freed)))
        return freed

    monkeypatch.setattr(drv.Loop, "admit", logged_admit)
    monkeypatch.setattr(drv.Loop, "step", logged_step)
    monkeypatch.setattr(drv, "run", lambda spec: records.append(
        run(spec)) or records[-1])
    load = harness.load_module
    monkeypatch.setattr(harness, "load_module", lambda kind, name: (
        drv if (kind, name) == ("drivers", "serve_closed")
        else load(kind, name)))
    bm, spec = tiny_cell(CELL, seconds=seconds, **wl_extra)
    result = harness.run_cell(bm, spec)
    return result, records[0], events


def test_a_deadline_inside_a_refill_ends_the_window_at_the_next_freeing_step(
        monkeypatch):
    _, rec, events = _run(monkeypatch, 300)
    # the run ends with the window, at a step that freed a slot
    assert events[-1][0] == "step" and events[-1][3]
    t0 = events[-1][1] - rec["window_s"]
    # an admission well inside the window: a refill
    start, end = next(e[1:] for e in events
                      if e[0] == "admit" and e[1] > t0 + 30)
    deadline = (start + end) / 2
    result, rec, events = _run(monkeypatch, deadline - t0)
    assert result["correct"]
    t1 = t0 + rec["window_s"]
    last = next(e for e in events
                if e[0] == "step" and e[1] >= deadline and e[3])
    # the window ends with that step, and no refill follows it
    assert t1 == last[1] > end and events[-1] == last
    steps = [e for e in events if e[0] == "step" and t0 < e[1] <= t1]
    admits = [e for e in events if e[0] == "admit" and t0 < e[2] <= t1]
    assert rec["steps"] == len(steps) and rec["admits"] == len(admits)
    assert rec["tokens"] == sum(e[2] for e in steps) + len(admits)


def test_most_requests_set_aside_still_compares_the_set_number(monkeypatch):
    monkeypatch.setattr(serve_ref, "NEAR_TIE", 0.0)
    _, rec, _ = _run(monkeypatch, 200, compared_requests=10 ** 6)
    margins = [row[3] for row in rec["reference"]["requests"]]
    margin = dict(zip(rec["reference"]["read"], margins))
    want = 4
    # all but the 6 widest margins set aside: most requests
    tie = sorted(margins, reverse=True)[want + 1]
    assert sum(m < tie for m in margins) > len(margins) / 2
    monkeypatch.setattr(serve_ref, "NEAR_TIE", tie)
    result, rec, _ = _run(monkeypatch, 200, compared_requests=want)
    read = rec["reference"]
    assert read["compared"] == want and read["near_ties"] >= 1
    assert read["near_ties"] == sum(margin[i] < tie for i in read["read"])
    assert result["correct"], result["checks"]


def test_every_request_set_aside_is_not_correct(monkeypatch):
    monkeypatch.setattr(serve_ref, "NEAR_TIE", float("inf"))
    result, rec, _ = _run(monkeypatch, 200)
    assert rec["reference"]["compared"] == 0
    assert rec["reference"]["near_ties"] == len(rec["reference"]["requests"])
    assert not result["correct"]


@pytest.mark.parametrize("want", [1, 3])
def test_the_longest_request_is_read_first(monkeypatch, want):
    _, every, _ = _run(monkeypatch, 200, compared_requests=10 ** 6)
    rows = every["reference"]["requests"]
    assert rows[0][0] + rows[0][1] == max(p + n for p, n, *_ in rows)
    _, rec, _ = _run(monkeypatch, 200, compared_requests=want)
    read = rec["reference"]
    assert read["compared"] == want
    assert read["requests"] == rows[:len(read["requests"])]


def test_a_longest_request_set_aside_is_followed_by_the_next_longest(
        monkeypatch):
    _, every, _ = _run(monkeypatch, 200, compared_requests=10 ** 6)
    rows = every["reference"]["requests"]
    # a near-tie bound just above the longest request's margin
    tie = rows[0][3] * (1 + 1e-6) + 1e-12
    assert sum(m >= tie for *_, m in rows) >= 3
    monkeypatch.setattr(serve_ref, "NEAR_TIE", tie)
    result, rec, _ = _run(monkeypatch, 200, compared_requests=3)
    read = rec["reference"]
    lengths = [p + n for p, n, *_ in read["requests"]]
    first = next(k for k, row in enumerate(read["requests"])
                 if row[3] >= tie)
    assert first >= 1 and read["set_aside"][0] == read["read"][0]
    # by length up to the first compared: the longest not set aside
    assert lengths[0] == max(p + n for p, n, *_ in rows)
    assert lengths[:first + 1] == sorted(lengths[:first + 1], reverse=True)
    assert lengths[first] == max(p + n for p, n, _, m in rows if m >= tie)
    assert read["compared"] == 3 and result["correct"], result["checks"]

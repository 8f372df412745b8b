"""The arithmetic of the end-to-end metrics on synthetic timestamps, and
the traffic generator's promises."""
import numpy as np
import pytest

from bench import harness, stats, traffic


def _loop(n_req=8, steps=60, step_s=0.5, stall_at=None, stall_s=0.0):
    """Token times of a closed loop: every request a token a step, one
    stall of ``stall_s`` before step ``stall_at``."""
    times, t = {r: [] for r in range(n_req)}, 0.0
    for i in range(steps):
        t += step_s + (stall_s if i == stall_at else 0.0)
        for r in times:
            times[r].append(t)
    return times, t


def _read(name, record):
    return harness.load_module("metrics", name).read(record)


def _serve_record(times, t1):
    return {"kind": "serve", "window_s": t1,
            "tokens": stats.window_count(times, 0.0, t1),
            "itl_gaps_s": stats.window_gaps(times, 0.0, t1)}


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 481):
        x = rng.exponential(size=n).tolist()
        for q in (0, 5, 50, 95, 100):
            assert stats.percentile(x, q) == pytest.approx(
                float(np.percentile(x, q)), rel=1e-12)


def test_a_stall_in_the_window_moves_the_tail_and_the_rate():
    calm, t_calm = _loop()
    a = _serve_record(calm, t_calm)
    assert _read("itl_p95_ms", a) == pytest.approx(500.0)
    assert _read("serve_tokens_per_s", a) == pytest.approx(16.0)
    # one stall of 2 s holds one step's 8 gaps of 472, under the 5 % tail:
    # the rate moves, the tail does not
    one, t_one = _loop(stall_at=30, stall_s=2.0)
    b = _serve_record(one, t_one)
    assert _read("itl_p95_ms", b) == pytest.approx(500.0)
    assert _read("serve_tokens_per_s", b) == pytest.approx(480 / 32.0)
    # a stall every 15 steps: 24 of 472 gaps, past the 5 % tail
    many = {r: [] for r in range(8)}
    t = 0.0
    for i in range(60):
        t += 0.5 + (2.0 if i % 15 == 5 else 0.0)
        for r in many:
            many[r].append(t)
    c = _serve_record(many, t)
    assert _read("itl_p95_ms", c) > 500.0
    assert _read("serve_tokens_per_s", c) == pytest.approx(480 / 38.0)


def test_window_edges():
    times = {0: [0.5, 1.0, 1.5, 2.0], 1: [1.2, 3.0]}
    assert stats.window_count(times, 1.0, 2.0) == 3      # (1, 2]
    assert stats.window_gaps(times, 1.0, 2.0) == [0.5]
    assert stats.window_gaps(times, 0.0, 3.0) == [0.5, 0.5, 0.5, 1.8]


def test_train_rate_and_mfu():
    rec = {"kind": "train", "tokens": 2048 * 10, "window_s": 4.0,
           "flops": 10 * 6.7e12}
    assert _read("train_tokens_per_s", rec) == 5120.0
    assert _read("train_mfu", rec) == pytest.approx(25.0)


def test_union_length_and_spread():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_every_seed_serves_the_same_sizes():
    wl = harness.load_cell("mixtral-8x22b.serve_decode")[2]
    want = (sorted(traffic.quantile_lengths(wl["prompt_len"], wl["pool"])),
            sorted(traffic.quantile_lengths(wl["output_len"], wl["pool"])))
    for seed in (0, 1, 2 ** 31 + 5, -7):
        pool = traffic.RequestPool(dict(wl, steady_start=False), seed, 100)
        reqs = [pool.next() for _ in range(wl["pool"])]
        assert (sorted(r.prompt.size for r in reqs),
                sorted(r.max_new for r in reqs)) == want
    # every request fits its slot's cache
    assert want[0][-1] + want[1][-1] <= wl["cache_len"]


def test_a_steady_start_gives_every_seed_the_same_work():
    wl = harness.load_cell("mixtral-8x22b.serve_decode")[2]
    n = wl["clients"]
    firsts = []
    for seed in (0, 1, 2 ** 31 + 5):
        pool = traffic.RequestPool(wl, seed, 100)
        firsts.append([(r.prompt.size, r.max_new)
                       for r in (pool.next() for _ in range(n + 1))])
    for f in firsts:
        assert sorted(p for p, _ in f[:n]) == sorted(
            traffic.quantile_lengths(wl["prompt_len"], n))
        assert sorted(o for _, o in f[:n]) == sorted(o for _, o in
                                                     firsts[0][:n])
        assert f[n] == (1020, 129)      # the medians: the window's refill
    assert firsts[0][:n] != firsts[1][:n]


def test_log_normal_lengths_keep_their_median_and_mean():
    spec = {"dist": "log_normal", "median": 1020, "mean": 1155}
    x = traffic.quantile_lengths(spec, 20001)
    assert np.median(x) == 1020 and x.min() >= 1
    assert x.mean() == pytest.approx(1155, rel=0.01)


def test_residual_lengths_are_the_forward_recurrence_quantiles():
    lengths = traffic.quantile_lengths({"min": 32, "max": 128,
                                        "dist": "uniform"}, 97)
    a = traffic.residual_lengths(lengths, 8, np.random.default_rng(0))
    b = traffic.residual_lengths(lengths, 8, np.random.default_rng(1))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    many = traffic.residual_lengths(lengths, 4000, np.random.default_rng(0))
    # E[R] = E[L^2] / (2 E[L]) + 1/2 for a discrete length
    want = (lengths.astype(float) ** 2).mean() / (2 * lengths.mean()) + 0.5
    assert many.mean() == pytest.approx(want, rel=0.01)
    assert many.min() >= 1 and many.max() <= 128


def test_train_batches_differ_and_repeat_by_seed():
    a = traffic.train_batches(2 ** 31 + 9, 4, 8, 1000)
    b = traffic.train_batches(2 ** 31 + 9, 4, 8, 1000)
    x0, y0 = next(a)
    x1, _ = next(a)
    assert (x0 == next(b)[0]).all() and not (x0 == x1).all()
    assert (x0[:, 1:] == y0[:, :-1]).all()

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


def _lengths(wl, seed, n):
    pool = traffic.RequestPool(wl, seed, 100)
    reqs = [pool.next() for _ in range(n)]
    return [(r.prompt.size, r.max_new) for r in reqs], reqs


def test_a_steady_start_gives_every_seed_the_same_work():
    wl = harness.load_cell("mixtral-8x22b.serve_decode")[2]
    n = wl["clients"]
    count = 2 * wl["pool"] + n + 1
    want, first = _lengths(wl, 0, count)
    for seed in (1, 2 ** 31 + 5, -7):
        got, reqs = _lengths(wl, seed, count)
        assert got == want
        assert any((a.prompt != b.prompt).any() for a, b in zip(first, reqs))
    assert sorted(p for p, _ in want[:n]) == sorted(
        traffic.quantile_lengths(wl["prompt_len"], n))
    assert want[n] == (1020, 129)       # the medians: the window's refill
    # then the pool, pass after pass in one order
    assert want[n + 1:n + 1 + wl["pool"]] == want[n + 1 + wl["pool"]:]


def test_any_24_consecutive_requests_span_the_prompt_law():
    wl = harness.load_cell("mixtral-8x22b.serve_decode")[2]
    got, _ = _lengths(wl, 2 ** 31 + 5, 2 * wl["pool"] + wl["clients"] + 1)
    law = np.sort(traffic.quantile_lengths(wl["prompt_len"], wl["pool"]))
    edges = law[[wl["pool"] // 4, wl["pool"] // 2, 3 * wl["pool"] // 4]]
    quartile = np.searchsorted(edges, [p for p, _ in got], side="right")
    for i in range(len(got) - 24 + 1):
        assert set(quartile[i:i + 24]) == {0, 1, 2, 3}, i


def test_the_fixed_order_pairs_long_prompts_with_every_output():
    wl = harness.load_cell("mixtral-8x22b.serve_decode")[2]
    n = wl["pool"]
    pairs = traffic.fixed_pairs(traffic.quantile_lengths(wl["prompt_len"], n),
                                traffic.quantile_lengths(wl["output_len"], n))
    assert list(traffic.spread_order(8, 2)) == [0, 4, 2, 6, 1, 5, 3, 7]
    p = np.argsort(np.argsort([a for a, _ in pairs]))
    o = np.argsort(np.argsort([b for _, b in pairs]))
    assert abs(np.corrcoef(p, o)[0, 1]) < 0.1
    median = np.median([a for a, _ in pairs])
    long_prompts = [b for a, b in pairs if a >= median]
    assert min(long_prompts) < 129 < max(long_prompts)


def test_log_normal_lengths_keep_their_median_and_mean():
    spec = {"dist": "log_normal", "median": 1020, "mean": 1155}
    x = traffic.quantile_lengths(spec, 20001)
    assert np.median(x) == 1020 and x.min() >= 1
    assert x.mean() == pytest.approx(1155, rel=0.01)


def test_residual_lengths_are_the_forward_recurrence_quantiles():
    lengths = traffic.quantile_lengths({"min": 32, "max": 128,
                                        "dist": "uniform"}, 97)
    a = traffic.residual_lengths(lengths, 8)
    assert list(a) == sorted(a) and len(set(a)) == 8
    many = traffic.residual_lengths(lengths, 4000)
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

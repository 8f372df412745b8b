"""The port's ScaDLES trainer slice against the reference, on the CPU.

* Numpy modules carried over (``core/buffer.py``, ``core/simclock.py``,
  ``core/injection.py``): identical outputs at equal seeds, and the
  reference's own claims (``tests/test_core.py``,
  ``tests/test_buffer_queue.py``) hold on the port.
* ``core/weighted_agg.py`` and ``models/mlp.py`` against their reference
  counterparts within 1e-6; ``tree.ravel`` against ``ravel_pytree``.
* ``ScaDLESTrainer`` against ``repro.core.ScaDLESTrainer`` over 20 rounds
  from the same parameters and numpy seeds, weighted and unweighted, with
  compression, injection and ``local_steps=2``: every host field of every
  round identical, loss within ``LOSS_RTOL * |loss| + LOSS_ATOL``, final
  parameters within ``PARAM_ATOL``.
* ``tests/test_system.py``'s claims on the port, and the observability
  invariants of ``tests/test_obs.py`` (a tracked run is bit-exact with an
  untracked one; the noop observer never counts flops).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import buffer as jbuf
from repro.core import injection as jinj
from repro.core import simclock as jclock
from repro.core import weighted_agg as jagg
from repro.core import ScaDLESConfig as JConfig
from repro.core import ScaDLESTrainer as JTrainer
from repro.data import ClassClusterData as JData
from repro.data import DeviceDataSource as JSource
from repro.obs.mfu import DEVICE_PEAK_FLOPS as JAX_PEAK_FLOPS
from repro.obs.mfu import mfu as jax_mfu
from repro_torch.convert import tree_from_jax
from repro_torch.core import (PERSISTENCE, TRUNCATION, CountingBuffer,
                              SampleBuffer, ScaDLESConfig, ScaDLESTrainer,
                              queue_size_eqn2, queue_size_eqn3,
                              simulate_queue_growth)
from repro_torch.core import buffer as tbuf
from repro_torch.core import injection as tinj
from repro_torch.core import simclock as tclock
from repro_torch.core import weighted_agg as tagg
from repro_torch.data import ClassClusterData, DeviceDataSource
from repro_torch.models.mlp import make_mlp
from repro_torch.obs import (DEVICE_PEAK_FLOPS, NOOP, TRAIN_ROUND,
                             TRAIN_SUMMARY, MemoryTracker, RoundObserver,
                             counted_flops, mfu)
from repro_torch.tree import leaves, ravel, tree_map

# port vs reference, per round and at the end.  Both sum in f32 in
# different orders (XLA's fused reductions against ATen's), so a round's
# loss differs by a few ulps of the O(1) logits (at most 5.0e-7 over seeds
# 0-2 of every case below) and dense parameters by a few ulps (at most
# 2.5e-6).  Top-k is discontinuous in its input: an entry within f32 noise
# of the k-th magnitude can be kept on one side and dropped on the other,
# which moves that parameter by lr * |g_k| and every later gradient a
# little (at most 5.9e-4 in the parameters and 6.4e-4 in the energy gap
# over seeds 0-2).  Every host decision (batches, buffers, clock, which
# rounds compress) must be identical all the same.
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_ATOL = {False: 1e-5, True: 2e-3}        # keyed by "compressed"
GAP_ATOL = 2e-3
ROUNDS = 20


# ---------------------------------------------------------------------------
# numpy carry-overs: identical at equal seeds


@pytest.mark.parametrize("policy", [PERSISTENCE, TRUNCATION])
@pytest.mark.parametrize("t_iter,rate,batch,T", [
    (1.0, 100, 32, 50), (2.5, 300, 64, 200), (0.7, 250, 128, 400),
    (1.2, 10, 64, 30)])
def test_queue_growth_identical(policy, t_iter, rate, batch, T):
    port = simulate_queue_growth(t_iter, rate, batch, T, policy)
    ref = jbuf.simulate_queue_growth(t_iter, rate, batch, T, policy)
    np.testing.assert_array_equal(port, ref)
    assert queue_size_eqn2(t_iter, rate, batch, T) == \
        jbuf.queue_size_eqn2(t_iter, rate, batch, T)
    assert queue_size_eqn3(t_iter, rate, T) == \
        jbuf.queue_size_eqn3(t_iter, rate, T)


def test_eqn2_and_truncation_claims_hold_on_the_port():
    sizes = simulate_queue_growth(2.5, 300, 64, 200, PERSISTENCE)
    assert sizes[-1] == pytest.approx(queue_size_eqn2(2.5, 300, 64, 200),
                                      rel=0.01, abs=2.0)
    assert queue_size_eqn2(1.0, 10, 64, 100) == pytest.approx(10.0)
    trunc = simulate_queue_growth(1.5, 400, 32, 300, TRUNCATION)
    assert np.max(trunc) <= 1.5 * 400 + 1
    pers = simulate_queue_growth(1.5, 400, 32, 300, PERSISTENCE)
    assert pers[-1] > trunc[-1] * 50


def _counting_script(mod, policy):
    b = mod.CountingBuffer(policy=policy)
    rng = np.random.default_rng(3)
    for i in range(40):
        b.step(float(rng.uniform(0, 200)), float(rng.uniform(0, 150)))
        if i % 7 == 3:
            b.refund(float(rng.uniform(0, 30)))
        if i % 13 == 12:
            b.clear()
    return dataclasses.asdict(b)


@pytest.mark.parametrize("policy", [PERSISTENCE, TRUNCATION])
def test_counting_buffer_identical(policy):
    port = _counting_script(tbuf, policy)
    assert port == _counting_script(jbuf, policy)
    assert port["size"] == pytest.approx(
        port["total_streamed"] - port["total_consumed"]
        - port["total_dropped"])


def _sample_script(mod, policy, max_size, evict):
    b = mod.SampleBuffer(policy=policy, max_size=max_size, evict=evict)
    rng = np.random.default_rng(5)
    taken = []
    for i in range(30):
        b.stream_in(int(rng.integers(0, 40)))
        b.extend(list(rng.integers(1000, 2000, size=3)))
        taken.append(b.take(int(rng.integers(0, 30))))
        if i == 17:
            b.clear()
    return (taken, list(b._q), b.peak, b.total_streamed, b.total_taken,
            b.total_dropped)


@pytest.mark.parametrize("policy,max_size,evict", [
    (PERSISTENCE, None, "drop-oldest"), (TRUNCATION, None, "drop-oldest"),
    (PERSISTENCE, 25, "drop-oldest"), (PERSISTENCE, 25, "drop-newest")])
def test_sample_buffer_identical(policy, max_size, evict):
    port = _sample_script(tbuf, policy, max_size, evict)
    assert port == _sample_script(jbuf, policy, max_size, evict)
    _, q, _, streamed, taken, dropped = port
    assert streamed == len(q) + taken + dropped


def test_buffer_claims_hold_on_the_port():
    buf = SampleBuffer(policy=TRUNCATION)
    buf.stream_in(100)
    assert buf.take(10) == list(range(10))
    buf.stream_in(50)
    assert len(buf) == 50 and buf.total_dropped == 90 and buf.peak == 100
    cb = CountingBuffer(policy=TRUNCATION)
    cb.step(50.0, 50.0)
    cb.refund(50.0)
    cb.step(20.0, 0.0)
    assert cb.size == 20.0
    with pytest.raises(ValueError):
        SampleBuffer(max_size=0)
    with pytest.raises(ValueError):
        SampleBuffer(evict="drop-middle")


def test_clock_identical():
    rng = np.random.default_rng(0)
    for gbps, eff in ((5.0, 0.18), (1.0, 1.0)):
        cfg_kw = dict(bandwidth_gbps=gbps, bandwidth_efficiency=eff,
                      n_devices=16, grad_floats=60.2e6)
        port = tclock.EdgeClock(tclock.EdgeClockConfig(**cfg_kw))
        ref = jclock.EdgeClock(jclock.EdgeClockConfig(**cfg_kw))
        for _ in range(25):
            kw = dict(wait_s=float(rng.uniform(0, 3)),
                      local_batch=float(rng.uniform(0, 256)),
                      floats_on_wire=float(rng.uniform(1e5, 6e7)),
                      extra_bytes=float(rng.uniform(0, 1e6)))
            assert port.step(**kw) == ref.step(**kw)
        assert port.time_s == ref.time_s
        assert tclock.effective_bandwidth_Bps(gbps, eff) == \
            jclock.effective_bandwidth_Bps(gbps, eff)
    rates = rng.uniform(0, 300, 16)
    queues = rng.uniform(0, 100, 16)
    np.testing.assert_array_equal(
        tclock.ddl_streaming_wait_per_device(rates, queues, 64),
        jclock.ddl_streaming_wait_per_device(rates, queues, 64))
    assert tclock.ddl_streaming_wait(rates, queues, 64) == \
        jclock.ddl_streaming_wait(rates, queues, 64)
    assert tclock.ddl_streaming_wait(np.array([10.0, 100.0]), np.zeros(2),
                                     64) == pytest.approx(6.4)
    cal = tclock.EdgeClock(tclock.EdgeClockConfig(n_devices=16))
    share = cal.comm_time(60.2e6) / (cal.comm_time(60.2e6) + 1.2)
    assert 0.7 < share < 0.9


@pytest.mark.parametrize("alpha,beta", [(0.5, 0.25), (0.2, 0.5), (0.0, 0.5),
                                        (0.5, 0.0)])
def test_injection_identical(alpha, beta):
    data = ClassClusterData(num_classes=10, train_per_class=16,
                            test_per_class=2, noise=0.8, seed=0)
    src = DeviceDataSource(data, 6, iid=False, labels_per_device=2)
    xs, ys, _ = src.batches(np.random.default_rng(1), np.full(6, 16), 16)
    out = []
    for mod in (tinj, jinj):
        rng = np.random.default_rng(7)
        senders, n_share = mod.injection_plan(rng, 6, alpha, beta, 16)
        xd, yd, moved = mod.inject_batches(rng, xs, ys, senders, n_share)
        out.append((senders, n_share, xd, yd, moved,
                    mod.label_emd(yd, 10),
                    mod.injection_overhead_bytes(alpha, beta, 6, 16, 3072)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    senders, n_share, _, yd, moved, emd_after, _ = out[0]
    if senders.any() and n_share:
        assert moved > 0 and emd_after < tinj.label_emd(ys, 10)
        for d in np.flatnonzero(~senders):
            assert np.any(np.isin(yd[d], ys[senders].reshape(-1)))


# ---------------------------------------------------------------------------
# weighted aggregation, the MLP, ravel


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_rate_weights_and_linear_scaling_match():
    rng = np.random.default_rng(0)
    for n in (2, 7, 16):
        rates = rng.integers(1, 500, size=n).astype(np.float32)
        np.testing.assert_allclose(
            tagg.rate_weights(torch.from_numpy(rates)).numpy(),
            np.asarray(jagg.rate_weights(jnp.asarray(rates))), atol=1e-6)
        assert float(tagg.rate_weights(torch.from_numpy(rates)).sum()) == \
            pytest.approx(1.0, abs=1e-5)
        for base in (16 * 64.0, 1000.0):
            assert float(tagg.linear_scaled_lr(
                0.05, torch.from_numpy(rates), base)) == pytest.approx(
                float(jagg.linear_scaled_lr(0.05, jnp.asarray(rates), base)),
                abs=1e-6)
    assert float(tagg.linear_scaled_lr(0.1, torch.full((16,), 128.0),
                                       16 * 64.0)) == pytest.approx(0.2)
    np.testing.assert_array_equal(
        tagg.clip_batch(torch.tensor([1.0, 50.0, 5000.0]), 8, 1024).numpy(),
        np.asarray(jagg.clip_batch(jnp.array([1.0, 50.0, 5000.0]), 8, 1024)))
    div = rng.uniform(0, 1, 7)
    np.testing.assert_array_equal(
        tagg.skew_corrected_rates(np.arange(7.0), div, 0.05),
        jagg.skew_corrected_rates(np.arange(7.0), div, 0.05))


@pytest.mark.parametrize("normalize", [True, False])
def test_weighted_aggregate_matches(normalize):
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(5, 3072, 64)).astype(np.float32),
             "b": {"c": rng.normal(size=(5, 10)).astype(np.float32)}}
    w = rng.uniform(0, 3, 5).astype(np.float32)
    port = tagg.weighted_aggregate(tree_from_jax(grads, device="cpu"),
                                   torch.from_numpy(w), normalize=normalize)
    ref = jagg.weighted_aggregate(jax.tree.map(jnp.asarray, grads),
                                  jnp.asarray(w), normalize=normalize)
    np.testing.assert_allclose(port["w"].numpy(), np.asarray(ref["w"]),
                               atol=1e-6)
    np.testing.assert_allclose(port["b"]["c"].numpy(),
                               np.asarray(ref["b"]["c"]), atol=1e-6)
    g = {"w": torch.arange(12.0).reshape(3, 4)}
    out = tagg.weighted_aggregate(g, torch.tensor([1.0, 2.0, 7.0]))
    np.testing.assert_allclose(
        out["w"].numpy(), (0.1 * g["w"][0] + 0.2 * g["w"][1]
                           + 0.7 * g["w"][2]).numpy(), rtol=1e-6)


def jax_mlp(d_in=32 * 32 * 3, hidden=64, classes=10):
    """``benchmarks/common.py::make_mlp``, the model the reference trains."""
    def init(key):
        k1, k2 = jax.random.split(key)
        return {"w1": jax.random.normal(k1, (d_in, hidden)) * 0.02,
                "b1": jnp.zeros(hidden),
                "w2": jax.random.normal(k2, (hidden, classes)) * 0.02,
                "b2": jnp.zeros(classes)}

    def per_sample_loss(p, x, y):
        h = jax.nn.relu(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
        return lse - gold

    def predict(p, x):
        h = jax.nn.relu(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    return {"init": init, "per_sample_loss": per_sample_loss,
            "predict": predict}


def port_model_from(jax_params):
    """The port's MLP whose ``init`` returns the reference's parameters."""
    model = make_mlp()
    params = tree_from_jax(_numpy_tree(jax_params), device="cpu")
    model["init"] = lambda gen, device: tree_map(torch.clone, params)
    return model


def test_mlp_matches_reference():
    jm = jax_mlp()
    jp = jm["init"](jax.random.PRNGKey(0))
    tm = make_mlp()
    tp = tree_from_jax(_numpy_tree(jp), device="cpu")
    assert sum(x.numel() for x in leaves(tp)) == 197_322
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 9).astype(np.int32)
    np.testing.assert_allclose(
        tm["per_sample_loss"](tp, torch.from_numpy(x),
                              torch.from_numpy(y)).numpy(),
        np.asarray(jm["per_sample_loss"](jp, jnp.asarray(x),
                                         jnp.asarray(y))), atol=1e-6)
    np.testing.assert_allclose(
        tm["predict"](tp, torch.from_numpy(x)).numpy(),
        np.asarray(jm["predict"](jp, jnp.asarray(x))), atol=1e-6)
    # its own init: seeded, the reference's shapes and scales
    a = tm["init"](torch.Generator().manual_seed(3), "cpu")
    b = tm["init"](torch.Generator().manual_seed(3), "cpu")
    for key in a:
        assert torch.equal(a[key], b[key]) and a[key].shape == \
            tuple(jp[key].shape)
    assert 0.015 < float(a["w1"].std()) < 0.025
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tm["init"](torch.Generator().manual_seed(3))


def test_masked_mean_grads_matches():
    jm = jax_mlp()
    jp = jm["init"](jax.random.PRNGKey(1))
    tp = tree_from_jax(_numpy_tree(jp), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 3072)).astype(np.float32)
    y = rng.integers(0, 10, 12).astype(np.int32)
    mask = (np.arange(12) < 7).astype(np.float32)
    tl, tg = tagg.masked_mean_grads(
        lambda p, b: make_mlp()["per_sample_loss"](p, *b), tp,
        (torch.from_numpy(x), torch.from_numpy(y)), torch.from_numpy(mask))
    jl, jg = jagg.masked_mean_grads(
        lambda p, b: jm["per_sample_loss"](p, *b), jp,
        (jnp.asarray(x), jnp.asarray(y)), jnp.asarray(mask))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    for key in tg:
        np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                   atol=1e-6)


def test_ravel_matches_ravel_pytree():
    rng = np.random.default_rng(4)
    tree = {"z": rng.normal(size=(3, 2)).astype(np.float32),
            "a": {"y": rng.normal(size=(4,)).astype(np.float32),
                  "b": rng.normal(size=(2, 2, 2)).astype(np.float32)}}
    flat, unravel = ravel(tree_from_jax(tree, device="cpu"))
    jflat, _ = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat)
    np.testing.assert_array_equal(back["a"]["b"].numpy(), tree["a"]["b"])
    stacked = unravel(torch.stack([flat, 2 * flat]))
    np.testing.assert_array_equal(stacked["z"][1].numpy(), 2 * tree["z"])


def test_tree_from_jax_copies_and_checks():
    src = {"w": np.ones((2, 3), np.float32), "n": {"i": np.arange(3)}}
    out = tree_from_jax(src, device="cpu")
    out["w"] += 1
    assert src["w"][0, 0] == 1.0 and out["n"]["i"].dtype == torch.int64
    with pytest.raises(ValueError):
        tree_from_jax([np.ones(2)], device="cpu")
    with pytest.raises(ValueError):
        tree_from_jax({"w": 1.5}, device="cpu")


# ---------------------------------------------------------------------------
# the trainer, port vs reference


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_classes=10, train_per_class=48, test_per_class=8,
              noise=0.8, seed=0)
    return JData(**kw), ClassClusterData(**kw)


def run_both(datasets, steps, iid=True, **kw):
    """The reference and the port from the same parameters and seeds."""
    jdata, tdata = datasets
    jm = jax_mlp()
    jfleet, tfleet = kw.pop("fleet", (None, None))
    n = kw["n_devices"]
    ref = JTrainer(jm, JSource(jdata, n, iid=iid, labels_per_device=2),
                   JConfig(fleet=jfleet, **kw))
    port = ScaDLESTrainer(port_model_from(ref.params),
                          DeviceDataSource(tdata, n, iid=iid,
                                           labels_per_device=2),
                          ScaDLESConfig(fleet=tfleet, device="cpu", **kw))
    ref.run(steps)
    port.run(steps)
    return ref, port


def assert_same_history(ref, port):
    assert len(ref.history) == len(port.history)
    for r, p in zip(ref.history, port.history):
        assert set(r) == set(p)
        for key in r:
            if key not in ("loss", "gap"):
                assert p[key] == r[key], (key, r["step"])
        assert abs(p["loss"] - r["loss"]) <= (LOSS_RTOL * abs(r["loss"])
                                              + LOSS_ATOL), r["step"]
        assert abs(p["gap"] - r["gap"]) <= GAP_ATOL, r["step"]
    for key in port.params:
        np.testing.assert_allclose(
            port.params[key].numpy(), np.asarray(ref.params[key]),
            atol=PARAM_ATOL[port.compressor is not None], rtol=0)
    assert port.summary() == pytest.approx(ref.summary(), rel=1e-12)


BASE = dict(n_devices=4, dist="S1", b_max=32)


@pytest.mark.parametrize("kw", [
    dict(weighted=True),
    dict(weighted=False),
    dict(weighted=True, policy=TRUNCATION, compression=(0.1, 0.3)),
    dict(weighted=False, compression=(0.25, 0.5)),
    dict(weighted=True, injection=(0.5, 0.5)),
    dict(weighted=True, local_steps=2),
    dict(weighted=True, compression=(0.1, 0.3), injection=(0.5, 0.25),
         local_steps=2, weight_decay=1e-4, n_devices=6, b_max=48),
], ids=["weighted", "ddl", "compressed-truncation", "ddl-compressed",
        "injection", "local-steps-2", "all"])
def test_trainer_matches_reference(datasets, kw):
    ref, port = run_both(datasets, ROUNDS, **{**BASE, **kw})
    assert_same_history(ref, port)
    if kw.get("compression"):
        assert 0 < port.summary()["cnc_ratio"] <= 1


def test_trainer_matches_reference_non_iid(datasets):
    ref, port = run_both(datasets, ROUNDS, iid=False, n_devices=5, dist="S2",
                         b_max=40, injection=(0.4, 0.5))
    assert_same_history(ref, port)


# ---------------------------------------------------------------------------
# the reference's system claims (tests/test_system.py) on the port


@pytest.fixture(scope="module")
def system_data():
    return ClassClusterData(num_classes=10, train_per_class=128,
                            test_per_class=32, noise=0.8, seed=0)


def _acc(model, params, data):
    logits = model["predict"](params, torch.from_numpy(data.test_x))
    return float(np.mean(logits.argmax(-1).numpy() == data.test_y))


def _trainer(model, src, **kw):
    return ScaDLESTrainer(model, src, ScaDLESConfig(device="cpu", **kw))


def test_port_scadles_faster_than_ddl(system_data):
    model = make_mlp()
    src = DeviceDataSource(system_data, 8, iid=True)
    sc = _trainer(model, src, n_devices=8, dist="S1", weighted=True,
                  b_max=64, base_lr=0.05)
    dd = _trainer(model, src, n_devices=8, dist="S1", weighted=False,
                  b_max=64, base_lr=0.05)
    sc.run(15)
    dd.run(15)
    assert _acc(model, sc.params, system_data) > 0.6
    assert _acc(model, dd.params, system_data) > 0.6
    assert dd.clock.time_s / sc.clock.time_s > 1.1


def test_port_truncation_bounds_buffers(system_data):
    # b_max 64 (the reference leaves 1024): the DDL batch is 64, so the
    # draw, and the training, are the same; only the zero padding shrinks
    model = make_mlp()
    src = DeviceDataSource(system_data, 8, iid=True)
    pers = _trainer(model, src, n_devices=8, dist="S2", weighted=False,
                    policy=PERSISTENCE, b_max=64)
    trun = _trainer(model, src, n_devices=8, dist="S2", weighted=False,
                    policy=TRUNCATION, b_max=64)
    pers.run(20)
    trun.run(20)
    assert pers.summary()["buffer_final"] > 8 * trun.summary()["buffer_final"]


def test_port_injection_trains(system_data):
    model = make_mlp()
    src = DeviceDataSource(system_data, 10, iid=False, labels_per_device=1)
    # b_max 192 (the reference leaves 1024): S1p rates (normal, 64 +- 24)
    # pass 192 with probability ~1e-7, so no batch is cut
    inj = _trainer(model, src, n_devices=10, dist="S1p", weighted=True,
                   base_lr=0.03, seed=1, b_max=192, injection=(0.5, 0.5))
    inj.run(25)
    assert _acc(model, inj.params, system_data) > 0.8
    assert inj.history[-1]["inj_bytes"] > 0


def test_port_adaptive_compression_reduces_floats(system_data):
    model = make_mlp()
    src = DeviceDataSource(system_data, 8, iid=True)
    # b_max 128 (the reference leaves 1024): above every S1 rate
    comp = _trainer(model, src, n_devices=8, dist="S1", weighted=True,
                    b_max=128, compression=(0.1, 0.3))
    comp.run(25)
    s = comp.summary()
    assert s["cnc_ratio"] > 0.5
    assert s["floats_sent"] / comp.cfg.n_devices < 0.6 * 25 * comp.n_floats
    assert _acc(model, comp.params, system_data) > 0.6
    tight = _trainer(model, DeviceDataSource(system_data, 4, iid=True),
                     n_devices=4, dist="S1", weighted=True, b_max=128,
                     compression=(0.01, 1e-5))
    tight.run(10)
    assert tight.summary()["cnc_ratio"] == 0.0


# ---------------------------------------------------------------------------
# observability


def _tracked_pair(datasets, **kw):
    _, tdata = datasets
    jp = jax_mlp()["init"](jax.random.PRNGKey(0))
    out = []
    for tracker in (MemoryTracker(), None):
        tr = ScaDLESTrainer(port_model_from(jp),
                            DeviceDataSource(tdata, 4, iid=True),
                            ScaDLESConfig(n_devices=4, b_max=32,
                                          grad_floats=60.2e6, device="cpu",
                                          tracker=tracker, **kw))
        tr.run(5)
        out.append(tr)
    return out


@pytest.mark.parametrize("kw", [{}, {"compression": (0.1, 0.3)}],
                         ids=["dense", "compressed"])
def test_tracked_run_is_bit_exact_and_emits_rounds(datasets, kw):
    tracked, plain = _tracked_pair(datasets, **kw)
    mt = tracked.tracker
    rounds = [r["data"] for r in mt.of_kind(TRAIN_ROUND)]
    assert len(rounds) == 5 and len(mt.of_kind(TRAIN_SUMMARY)) == 1
    # the step's products, counted on meta copies: per device, forward 2bdh
    # + 2bhc and backward 2bdh + 4bhc (no gradient for x), plus the Eqn-4b
    # tensordot, 2Dn
    b, d, h, c, D, n = 32, 3072, 64, 10, 4, 197_322
    flops = D * (4 * b * d * h + 6 * b * h * c) + 2 * D * n
    assert all(r["step_flops"] == flops for r in rounds)
    assert all(0.0 < r["mfu"] < 1.0 for r in rounds)
    assert rounds[0]["mfu"] == pytest.approx(
        jax_mfu(flops, rounds[0]["dt_s"], n_devices=4))
    for h_t, h_p in zip(tracked.history, plain.history):
        assert h_t["loss"] == h_p["loss"]
    for key in tracked.params:
        assert torch.equal(tracked.params[key], plain.params[key])
    assert plain._obs._flops_cache == {} and not plain._obs.active


def test_noop_observer_never_counts():
    obs = RoundObserver(NOOP, n_devices=8)
    assert not obs.active and obs._flops_cache == {}
    assert DEVICE_PEAK_FLOPS == JAX_PEAK_FLOPS
    assert mfu(1e12, 2.0, n_devices=4) == jax_mfu(1e12, 2.0, n_devices=4)
    assert mfu(None, 1.0) == 0.0 and mfu(1e9, 0.0) == 0.0


def test_counted_flops_leaves_arguments_alone():
    w = torch.randn(64, 32)
    x = torch.randn(8, 64)
    before = w.clone()
    assert counted_flops(lambda a, b: (b @ a).relu_(), w, x) == 2 * 8 * 64 * 32
    assert torch.equal(w, before)
    # a step that reads a value on the host cannot run on meta: no count
    assert counted_flops(lambda a: float(a.sum()) * a, w) is None

"""The port's non-IID streaming data plane (``repro_torch.streamdata``)
against the reference's, on the CPU.

Mirrors ``tests/test_streamdata.py`` case by case, holding the port to the
reference instead of to constants (the reference's claims are asserted on
the port too):

* partitions (``iid``, ``dirichlet`` at α 0.05 / 0.1 / 0.3 / 100 / inf,
  ``shard``, ``quantity``), divergences, entropies and coverages identical
  at equal seeds, empty devices rebalanced alike;
* ``SampleBuffer`` eviction and conservation, ``StreamSimulator`` with an
  explicit rng and a rate curve, ``DiurnalCurve`` / ``quantity_rate_curve``
  / ``compose_curves``, drift states and source batches: identical;
* the sharded loader: identical ids, buffers, masks and conservation
  counts, short batches included;
* the port's own IID bit-exactness: a port trainer fed by
  ``make_stream_source(skew="iid")`` gives params bit-identical to one fed
  by ``DeviceDataSource(iid=True)``;
* the trainer's non-IID hooks (time-aware draws, ``on_arrivals``,
  ``label_divergence``, skew weighting on the lockstep and the carry path,
  non-IID damping, the fleet's divergence telemetry, the hill-climb
  controller's skew EWMA) over 20 rounds at 8 devices against
  ``repro.core.ScaDLESTrainer``: every host field identical, loss within
  ``LOSS_RTOL * |loss| + LOSS_ATOL`` and params within ``PARAM_ATOL``, the
  tolerances ``tests/test_torch_scadles.py`` states and explains;
* the controller's skew flip, identical in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScaDLESConfig as JConfig
from repro.core import ScaDLESTrainer as JTrainer
from repro.core import buffer as jbuf
from repro.core import streams as jstreams
from repro.data import ClassClusterData as JData
from repro.data import DeviceDataSource as JSource
from repro.fleet import FleetConfig as JFleet
from repro.fleet import control as jcontrol
from repro.fleet.engine import RoundTelemetry as JTelemetry
import repro.streamdata as jsd
from repro_torch.convert import tree_from_jax
from repro_torch.core import ScaDLESConfig, ScaDLESTrainer
from repro_torch.core import buffer as tbuf
from repro_torch.core import streams as tstreams
from repro_torch.data import ClassClusterData, DeviceDataSource
from repro_torch.fleet import FleetConfig
from repro_torch.fleet import control as tcontrol
from repro_torch.fleet.engine import RoundTelemetry
from repro_torch.models.mlp import make_mlp
import repro_torch.streamdata as tsd
from repro_torch.tree import leaves, tree_map

# port vs reference: tests/test_torch_scadles.py's tolerances (f32 sums in
# different orders; top-k may flip an entry within f32 noise of the k-th)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_ATOL = {False: 1e-5, True: 2e-3}        # keyed by "compressed"
GAP_ATOL = 2e-3
ROUNDS = 20
DATA_KW = dict(num_classes=10, train_per_class=48, test_per_class=8,
               noise=0.8, seed=0)


@pytest.fixture(scope="module")
def datasets():
    return JData(**DATA_KW), ClassClusterData(**DATA_KW)


@pytest.fixture(scope="module")
def labels(datasets):
    return np.asarray(datasets[1].train_y)


def assert_same_partition(p, r):
    assert (p.kind, p.alpha, p.n_devices, p.num_classes) == \
        (r.kind, r.alpha, r.n_devices, r.num_classes)
    assert len(p.assignments) == len(r.assignments)
    for a, b in zip(p.assignments, r.assignments):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(p.class_probs, r.class_probs)
    np.testing.assert_array_equal(p.global_probs, r.global_probs)
    for fn in ("counts", "shares", "divergence", "entropy"):
        np.testing.assert_array_equal(getattr(p, fn)(), getattr(r, fn)())


# ---------------------------------------------------------------------------
# dataset label balance and partitioners


def test_class_cluster_data_identical(datasets):
    jdata, tdata = datasets
    np.testing.assert_array_equal(tdata.train_x, jdata.train_x)
    np.testing.assert_array_equal(tdata.train_y, jdata.train_y)
    assert (np.bincount(tdata.train_y, minlength=10) == 48).all()


@pytest.mark.parametrize("skew,kw", [
    ("iid", {}),
    ("dirichlet", {"alpha": 0.05}),
    ("dirichlet", {"alpha": 0.1}),
    ("dirichlet", {"alpha": 0.3}),
    ("dirichlet", {"alpha": 100.0}),
    ("dirichlet", {"alpha": np.inf}),
    ("shard", {"shards_per_device": 1}),
    ("shard", {"shards_per_device": 4}),
    ("quantity", {"alpha": 0.5}),
    ("quantity", {"alpha": np.inf}),
])
def test_every_sample_assigned_exactly_once(labels, skew, kw):
    p = tsd.make_partition(labels, 8, skew=skew, seed=3, **kw)
    assert_same_partition(p, jsd.make_partition(labels, 8, skew=skew,
                                                seed=3, **kw))
    allocated = np.concatenate(p.assignments)
    assert np.array_equal(np.sort(allocated), np.arange(len(labels)))
    assert all(len(a) >= 1 for a in p.assignments)   # no starved device


@pytest.mark.parametrize("n_devices,alpha,seed", [(40, 0.05, 0), (64, 0.01, 1),
                                                  (30, 0.02, 2)])
def test_empty_devices_rebalanced_alike(labels, n_devices, alpha, seed):
    """Heavy skew over many devices leaves some with no sample before the
    deterministic rebalance; both packages steal the same samples."""
    p = tsd.make_partition(labels, n_devices, skew="dirichlet", alpha=alpha,
                           seed=seed)
    assert_same_partition(p, jsd.make_partition(
        labels, n_devices, skew="dirichlet", alpha=alpha, seed=seed))
    assert p.counts().min() >= 1 and p.counts().sum() == len(labels)
    # the rebalance is one pass in device order, stealing from the richest
    # device so far: a device emptied after its turn stays empty
    for lists, want in ((([5, 6], [], [7], []), [[], [6], [7], [5]]),
                        (([1, 2, 3], [], [4], []), [[1], [3], [4], [2]])):
        got = [mod._rebalance_empty([np.asarray(a, np.int64) for a in lists])
               for mod in (tsd.partition, jsd.partition)]
        assert [a.tolist() for a in got[0]] == \
            [a.tolist() for a in got[1]] == want


def test_iid_partition_divergence_exactly_zero(labels):
    p = tsd.make_partition(labels, 4, skew="iid", seed=0)
    assert_same_partition(p, jsd.make_partition(labels, 4, skew="iid",
                                                seed=0))
    assert p.divergence().max() == 0.0
    assert np.allclose(p.entropy(), np.log2(10))


def test_dirichlet_alpha_inf_recovers_iid(labels):
    p = tsd.make_partition(labels, 4, skew="dirichlet", alpha=np.inf, seed=0)
    assert p.divergence().max() < 0.05
    assert_same_partition(p, jsd.make_partition(
        labels, 4, skew="dirichlet", alpha=np.inf, seed=0))


def test_dirichlet_alpha_orders_skew(labels):
    lo = tsd.make_partition(labels, 8, skew="dirichlet", alpha=0.05, seed=1)
    mid = tsd.make_partition(labels, 8, skew="dirichlet", alpha=0.3, seed=1)
    hi = tsd.make_partition(labels, 8, skew="dirichlet", alpha=100.0, seed=1)
    assert lo.divergence().mean() > hi.divergence().mean() + 0.1
    assert lo.divergence().mean() > mid.divergence().mean() \
        > hi.divergence().mean()
    for p, a in ((lo, 0.05), (mid, 0.3), (hi, 100.0)):
        assert_same_partition(p, jsd.make_partition(
            labels, 8, skew="dirichlet", alpha=a, seed=1))


def test_one_class_shards_hit_max_divergence(labels):
    p = tsd.make_partition(labels, 10, skew="shard", shards_per_device=1,
                           seed=0)
    assert np.allclose(p.divergence(), tsd.max_divergence(10))
    assert np.allclose(p.entropy(), 0.0)
    assert tsd.max_divergence(10) == jsd.max_divergence(10)
    assert tsd.max_divergence(0) == jsd.max_divergence(0)


def test_quantity_skew_counts_unbalanced(labels):
    p = tsd.make_partition(labels, 8, skew="quantity", alpha=0.3, seed=2)
    c = p.counts()
    assert c.sum() == len(labels) and c.max() > 2 * c.min()
    assert_same_partition(p, jsd.make_partition(labels, 8, skew="quantity",
                                                alpha=0.3, seed=2))


def test_partition_determinism_and_explicit_rng(labels):
    a = tsd.make_partition(labels, 8, skew="dirichlet", alpha=0.2, seed=7)
    b = tsd.make_partition(labels, 8, skew="dirichlet", alpha=0.2, seed=7)
    assert_same_partition(a, b)
    port, ref = (mod.make_partition(labels, 6, skew="shard",
                                    shards_per_device=2,
                                    rng=np.random.default_rng(11))
                 for mod in (tsd, jsd))
    assert_same_partition(port, ref)


def test_metric_helpers_identical():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.full(10, 0.3), size=7)
    g = rng.dirichlet(np.full(10, 5.0))
    for fn, args in (("label_divergence", (probs, g)),
                     ("label_entropy", (probs,)),
                     ("label_coverage", (rng.uniform(0, 1, 9),)),
                     ("label_coverage", (rng.uniform(0, 1, 9), 0.2))):
        np.testing.assert_array_equal(getattr(tsd, fn)(*args),
                                      getattr(jsd, fn)(*args))
    assert tsd.label_coverage(np.array([0.0]))[0] == 1.0
    assert tsd.label_coverage(np.array([1.0]), floor=0.05)[0] == 0.05
    one_hot = np.zeros((1, 10))
    one_hot[0, 3] = 1.0
    assert tsd.label_divergence(one_hot, np.full(10, 0.1))[0] == \
        pytest.approx(0.9)
    assert tsd.label_entropy(one_hot)[0] == 0.0
    assert tsd.make_partition(np.zeros(8, np.int64), 2).kind == "iid"
    assert tsd.PARTITIONERS.keys() == jsd.PARTITIONERS.keys()
    for bad in (dict(skew="nope"), dict(skew="dirichlet", alpha=0.0),
                dict(skew="quantity", alpha=-1.0),
                dict(skew="shard", shards_per_device=0)):
        for mod in (tsd, jsd):
            with pytest.raises(ValueError):
                mod.make_partition(np.arange(8) % 2, 2, **bad)


# ---------------------------------------------------------------------------
# SampleBuffer eviction + conservation (the loader's buffers)


@pytest.mark.parametrize("evict,kept", [(tbuf.DROP_OLDEST, [2, 3, 4]),
                                        (tbuf.DROP_NEWEST, [0, 1, 2])])
def test_sample_buffer_eviction(evict, kept):
    out = []
    for mod in (tbuf, jbuf):
        b = mod.SampleBuffer(policy=mod.PERSISTENCE, max_size=3, evict=evict)
        b.extend([0, 1, 2, 3, 4])
        out.append((b.take(3), b.total_dropped, b.total_streamed,
                    b.total_taken, len(b)))
    assert out[0] == out[1]
    assert out[0][0] == kept and out[0][1] == 2
    assert out[0][2] == out[0][4] + out[0][3] + out[0][1]


def test_sample_buffer_conservation_random_traffic():
    for evict in (tbuf.DROP_OLDEST, tbuf.DROP_NEWEST):
        out = []
        for mod in (tbuf, jbuf):
            rng = np.random.default_rng(0)
            b = mod.SampleBuffer(max_size=16, evict=evict)
            taken = []
            for _ in range(200):
                b.extend(rng.integers(0, 1000,
                                      size=rng.integers(0, 9)).tolist())
                taken.append(b.take(int(rng.integers(0, 12))))
            out.append((taken, list(b._q), b.total_streamed, b.total_taken,
                        b.total_dropped))
        assert out[0] == out[1]
        _, q, streamed, taken_n, dropped = out[0]
        assert streamed == len(q) + taken_n + dropped and len(q) <= 16


# ---------------------------------------------------------------------------
# StreamSimulator and rate curves


def test_stream_simulator_explicit_rng_identical():
    traces = []
    for mod in (tstreams, jstreams):
        for _ in range(2):
            sim = mod.StreamSimulator(mod.TABLE_I["S1"], 4,
                                      rng=np.random.default_rng(42),
                                      intra_jitter=0.1)
            traces.append(np.stack([sim.rates_at(t) for t in range(10)]))
    for t in traces[1:]:
        np.testing.assert_array_equal(t, traces[0])


def test_rate_curve_applies_only_with_t_sim():
    curve = tsd.DiurnalCurve(day_s=50.0, amplitude=0.8,
                             phase=np.linspace(0, 1, 4, endpoint=False))
    out = []
    for mod in (tstreams, jstreams):
        sim = mod.StreamSimulator(mod.TABLE_I["S2"], 4, seed=0,
                                  rate_curve=curve)
        ref = mod.StreamSimulator(mod.TABLE_I["S2"], 4, seed=0)
        assert np.array_equal(sim.rates_at(0), ref.rates_at(0))
        out.append([sim.rates_at(t, t_sim=7.5 * t) for t in range(12)])
    np.testing.assert_array_equal(np.stack(out[0]), np.stack(out[1]))


def test_curves_identical(labels):
    phase = np.array([0.0, 0.25, 0.5, 0.75])
    port = tsd.DiurnalCurve(day_s=100.0, amplitude=2.0, floor=0.1,
                            phase=phase)
    ref = jsd.DiurnalCurve(day_s=100.0, amplitude=2.0, floor=0.1,
                           phase=phase)
    for t in np.linspace(0, 300, 41):
        np.testing.assert_array_equal(port(t), ref(t))
    v = tsd.DiurnalCurve(day_s=100.0, amplitude=2.0, floor=0.1,
                         phase=np.array([0.0, 0.5]))(75.0)
    assert v[0] == pytest.approx(0.1) and v[1] == pytest.approx(3.0)
    tp = tsd.make_partition(labels, 4, skew="quantity", alpha=0.3, seed=0)
    jp = jsd.make_partition(labels, 4, skew="quantity", alpha=0.3, seed=0)
    qp, qj = tsd.quantity_rate_curve(tp), jsd.quantity_rate_curve(jp)
    np.testing.assert_array_equal(qp(3.0), qj(3.0))
    assert qp(0.0).mean() == pytest.approx(1.0)
    cp = tsd.compose_curves(port, qp, lambda t: 0.5)
    cj = jsd.compose_curves(ref, qj, lambda t: 0.5)
    for t in (0.0, 33.0, 180.0):
        np.testing.assert_array_equal(cp(t), cj(t))
    assert float(tsd.compose_curves()(1.0)) == 1.0


def test_drift_weight_identical():
    for spec in (dict(kind="toward-uniform", t_scale=100.0),
                 dict(kind="rotate", t_scale=50.0, w_max=0.6),
                 dict(kind="rotate", t_scale=0.0, w_max=0.3)):
        port, ref = tsd.DriftSpec(**spec), jsd.DriftSpec(**spec)
        for t in (-5.0, 0.0, 10.0, 49.9, 75.0, 1e4):
            assert port.weight(t) == ref.weight(t)


# ---------------------------------------------------------------------------
# generators: drift, divergence and batches over sim time


def _sources(datasets, n, **kw):
    jdata, tdata = datasets
    drift = kw.pop("drift", None)
    return (tsd.make_stream_source(
                tdata, n, drift=None if drift is None else tsd.DriftSpec(
                    **drift), **kw),
            jsd.make_stream_source(
                jdata, n, drift=None if drift is None else jsd.DriftSpec(
                    **drift), **kw))


def _draw_both(port, ref, sizes, b_max, times, seed=0):
    out = []
    for src in (port, ref):
        rng = np.random.default_rng(seed)
        draws = []
        for t in times:
            xs, ys, masks = src.batches(rng, sizes, b_max, t_sim=t)
            draws.append((xs, ys, masks, src.label_divergence()))
        out.append(draws)
    for a, b in zip(*out):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    return out[0]


SOURCES = {
    "iid": dict(skew="iid"),
    "dirichlet-0.05": dict(skew="dirichlet", alpha=0.05),
    "dirichlet-0.3": dict(skew="dirichlet", alpha=0.3),
    "dirichlet-inf": dict(skew="dirichlet", alpha=np.inf),
    "shard-uniform-drift": dict(skew="shard", shards_per_device=1,
                                drift=dict(kind="toward-uniform",
                                           t_scale=100.0)),
    "dirichlet-rotate": dict(skew="dirichlet", alpha=0.1,
                             drift=dict(kind="rotate", t_scale=60.0,
                                        w_max=0.8)),
    "quantity": dict(skew="quantity", alpha=0.5, augment=False),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_batches_identical(datasets, name):
    port, ref = _sources(datasets, 6, seed=4, **SOURCES[name])
    assert port.iid == ref.iid
    sizes = np.array([0, 3, 17, 24, 9, 40])
    draws = _draw_both(port, ref, sizes, 24, (0.0, 15.0, 45.0, 200.0))
    for xs, ys, masks, div in draws:
        assert xs.shape == (6, 24, 32, 32, 3) and masks.sum() == \
            np.minimum(sizes, 24).sum()
        if port.iid:
            assert not div.any()


def test_streamdata_iid_replays_legacy_draw(datasets):
    """The IID source's draw is ``DeviceDataSource(iid=True)``'s, rng call
    for rng call, in both packages."""
    jdata, tdata = datasets
    sizes = np.array([5, 31, 12, 0])
    for data, mod, legacy in ((tdata, tsd, DeviceDataSource),
                              (jdata, jsd, JSource)):
        a = mod.make_stream_source(data, 4, skew="iid")
        b = legacy(data, 4, iid=True)
        ra, rb = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(3):
            for x, y in zip(a.batches(ra, sizes, 32),
                            b.batches(rb, sizes, 32)):
                np.testing.assert_array_equal(x, y)
        assert ra.random() == rb.random()


def test_drift_toward_uniform_decays_divergence(datasets):
    port, ref = _sources(datasets, 4, skew="shard", shards_per_device=1,
                         drift=dict(kind="toward-uniform", t_scale=100.0),
                         seed=0)
    draws = _draw_both(port, ref, np.full(4, 8), 8, (0.0, 100.0))
    early, late = draws[0][3].mean(), draws[1][3].mean()
    assert early > 0.5 and late < 1e-9


def test_drift_rotate_conserves_total_skew(datasets):
    port, ref = _sources(datasets, 4, skew="shard", shards_per_device=1,
                         drift=dict(kind="rotate", t_scale=100.0), seed=0)
    draws = _draw_both(port, ref, np.full(4, 8), 8, (0.0, 100.0))
    d0, d1 = draws[0][3], draws[1][3]
    assert d1.mean() == pytest.approx(d0.mean(), rel=0.2)
    assert d1.mean() > 0.5


def test_noniid_source_draws_from_own_pool(datasets, labels):
    jdata, tdata = datasets
    part = tsd.make_partition(labels, 10, skew="shard", shards_per_device=1,
                              seed=0)
    jpart = jsd.make_partition(labels, 10, skew="shard", shards_per_device=1,
                               seed=0)
    port = tsd.StreamingDataSource(tdata, 10, partition=part, augment=False)
    ref = jsd.StreamingDataSource(jdata, 10, partition=jpart, augment=False)
    (_, ys, masks, _), = _draw_both(port, ref, np.full(10, 16), 16, (0.0,),
                                    seed=1)
    for dev in range(10):
        own = set(labels[part.assignments[dev]].tolist())
        assert set(ys[dev][masks[dev] > 0].tolist()) <= own


def test_source_validation(datasets):
    _, tdata = datasets
    with pytest.raises(ValueError):
        tsd.StreamingDataSource(tdata, 4)                 # no partition
    part = tsd.make_partition(tdata.train_y, 4, skew="shard", seed=0)
    with pytest.raises(ValueError):
        tsd.StreamingDataSource(tdata, 4, partition=part,
                                drift=tsd.DriftSpec("sideways"))


# ---------------------------------------------------------------------------
# sharded loader


def _loaders(datasets, n, shards_per_device=4, skewed=False, **kw):
    jdata, tdata = datasets
    return (tsd.make_sharded_loader(tdata, n, shards_per_device, skewed,
                                    **kw),
            jsd.make_sharded_loader(jdata, n, shards_per_device, skewed,
                                    **kw))


def test_loader_placement_controls_skew(datasets):
    rr = _loaders(datasets, 4, skewed=False)
    sk = _loaders(datasets, 4, skewed=True)
    for port, ref in (rr, sk):
        np.testing.assert_array_equal(port.shard_owner, ref.shard_owner)
        assert_same_partition(port.partition, ref.partition)
    assert sk[0].label_divergence().mean() > \
        rr[0].label_divergence().mean() + 0.2


def _drive(loader, arrivals, rounds, sizes, b_max, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        loader.on_arrivals(np.asarray(arrivals))
        out.append(loader.batches(rng, np.asarray(sizes), b_max))
    bufs = [(list(b._q), b.total_streamed, b.total_taken, b.total_dropped,
             b.peak) for b in loader.buffers]
    cursors = [(st.cursor, st.frac) for st in loader.devices]
    return out, bufs, cursors, loader.conservation()


@pytest.mark.parametrize("evict", [tbuf.DROP_OLDEST, tbuf.DROP_NEWEST])
def test_loader_conservation_and_short_batches(datasets, evict):
    jdata, tdata = datasets
    port = tsd.ShardedStreamLoader(tdata, 3, tsd.make_label_shards(
        tdata.train_y, 6), placement=tsd.round_robin_placement,
        max_buffer=40, evict=evict, seed=0)
    ref = jsd.ShardedStreamLoader(jdata, 3, jsd.make_label_shards(
        jdata.train_y, 6), placement=jsd.round_robin_placement,
        max_buffer=40, evict=evict, seed=0)
    res = [_drive(ld, [3.7, 60.0, 0.4], 20, np.full(3, 8), 8)
           for ld in (port, ref)]
    for (a, b) in zip(res[0][0], res[1][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert res[0][1:] == res[1][1:]
    draws, _, _, c = res[0]
    assert c["balanced"] and c["dropped"] > 0
    assert port.buffers[2].total_streamed == int(0.4 * 20)
    assert any(m[2].sum() < 8 for _, _, m in draws)       # short batches
    assert any(m[2].sum() == 0 for _, _, m in draws)      # and empty ones


def test_loader_with_truncation_and_skew_identical(datasets):
    port, ref = _loaders(datasets, 5, shards_per_device=3, skewed=True,
                         policy=tbuf.TRUNCATION, max_buffer=25, seed=2)
    arrivals = [1.5, 12.0, 40.0, 0.3, 7.25]
    res = [_drive(ld, arrivals, 15, [4, 16, 30, 2, 10], 16, seed=5)
           for ld in (port, ref)]
    for (a, b) in zip(res[0][0], res[1][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert res[0][1:] == res[1][1:]
    assert res[0][3]["balanced"]
    np.testing.assert_array_equal(port.label_divergence(),
                                  ref.label_divergence())


def test_loader_rejects_bad_placement(datasets):
    _, tdata = datasets
    shards = tsd.make_label_shards(tdata.train_y, 4)
    with pytest.raises(ValueError):
        tsd.ShardedStreamLoader(tdata, 2, shards, placement=lambda s, n: 99)


def test_placements_identical():
    for n_shards, n_dev in ((8, 4), (12, 5), (3, 4)):
        place_t = tsd.contiguous_placement(n_shards)
        place_j = jsd.contiguous_placement(n_shards)
        assert [place_t(s, n_dev) for s in range(n_shards)] == \
            [place_j(s, n_dev) for s in range(n_shards)]
        assert [tsd.round_robin_placement(s, n_dev) for s in range(n_shards)] \
            == [jsd.round_robin_placement(s, n_dev) for s in range(n_shards)]
    assert {tsd.contiguous_placement(8)(s, 4) for s in range(8)} == \
        {0, 1, 2, 3}
    labels = np.random.default_rng(0).integers(0, 7, 101)
    for a, b in zip(tsd.make_label_shards(labels, 9),
                    jsd.make_label_shards(labels, 9)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the trainer's non-IID hooks, port vs reference


def jax_mlp(d_in=32 * 32 * 3, hidden=16, classes=10):
    """``tests/test_streamdata.py``'s model: the edge MLP at hidden 16."""
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

    return {"init": init, "per_sample_loss": per_sample_loss}


def port_model_from(jax_params):
    model = make_mlp(hidden=16)
    params = tree_from_jax(jax.tree.map(np.asarray, jax_params),
                           device="cpu")
    model["init"] = lambda gen, device: tree_map(torch.clone, params)
    return model


def _fleets(**kw):
    return JFleet(**kw), FleetConfig(**kw)


def run_both(make_sources, steps, curve=None, **kw):
    """The reference and the port from the same params, seeds and a fresh
    data source each (a source may be stateful)."""
    jsrc, tsrc = make_sources()
    jfleet, tfleet = kw.pop("fleet", (None, None))
    ref = JTrainer(jax_mlp(), jsrc, JConfig(fleet=jfleet, **kw))
    port = ScaDLESTrainer(port_model_from(ref.params), tsrc,
                          ScaDLESConfig(fleet=tfleet, device="cpu", **kw))
    if curve is not None:
        ref.sim.rate_curve, port.sim.rate_curve = curve
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
        assert np.isfinite(p["loss"]) == np.isfinite(r["loss"])
        assert abs(p["loss"] - r["loss"]) <= (LOSS_RTOL * abs(r["loss"])
                                              + LOSS_ATOL), r["step"]
        assert abs(p["gap"] - r["gap"]) <= GAP_ATOL, r["step"]
    for key in port.params:
        np.testing.assert_allclose(
            port.params[key].numpy(), np.asarray(ref.params[key]),
            atol=PARAM_ATOL[port.compressor is not None], rtol=0)
    assert port.summary() == pytest.approx(ref.summary(), rel=1e-12)
    if port.fleet is not None:
        assert port.fleet.telemetry_summary() == pytest.approx(
            ref.fleet.telemetry_summary(), rel=1e-12)


def _stream_sources(datasets, n, **kw):
    jdata, tdata = datasets
    drift = kw.pop("drift", None)

    def make():
        return (jsd.make_stream_source(
                    jdata, n, drift=drift and jsd.DriftSpec(**drift), **kw),
                tsd.make_stream_source(
                    tdata, n, drift=drift and tsd.DriftSpec(**drift), **kw))
    return make


def test_port_streamdata_iid_bit_exact_with_legacy(datasets):
    """``tests/test_streamdata.py::test_streamdata_iid_bit_exact_with_legacy``
    on the port: the IID streamdata source and ``DeviceDataSource(iid=True)``
    give the same losses and bit-identical params."""
    _, tdata = datasets
    jp = jax_mlp()["init"](jax.random.PRNGKey(0))
    kw = dict(n_devices=4, dist="S1", b_max=32, seed=0, device="cpu")
    legacy = ScaDLESTrainer(port_model_from(jp),
                            DeviceDataSource(tdata, 4, iid=True),
                            ScaDLESConfig(**kw))
    stream = ScaDLESTrainer(port_model_from(jp),
                            tsd.make_stream_source(tdata, 4, skew="iid"),
                            ScaDLESConfig(**kw))
    h_l, h_s = legacy.run(5), stream.run(5)
    assert [r["loss"] for r in h_l] == [r["loss"] for r in h_s]
    assert all(r["label_div_mean"] == 0.0 for r in h_s)
    for a, b in zip(leaves(legacy.params), leaves(stream.params)):
        assert torch.equal(a, b)                      # bit-exact


BASE = dict(n_devices=8, dist="S1", b_max=40, seed=0)


def test_dirichlet_skew_weighting_matches_reference(datasets):
    """The example's ScaDLES arm under ``--skew dirichlet``: lockstep,
    truncation, adaptive top-k, skew-corrected weights."""
    ref, port = run_both(
        _stream_sources(datasets, 8, skew="dirichlet", alpha=0.1, seed=0),
        ROUNDS, weighted=True, policy=tbuf.TRUNCATION,
        compression=(0.1, 0.3), skew_weighting=True, **BASE)
    assert_same_history(ref, port)
    assert port.history[-1]["label_div_mean"] > 0.1
    assert port.history[-1]["label_div_max"] >= \
        port.history[-1]["label_div_mean"]


@pytest.mark.parametrize("policy,knobs", [("async", {}),
                                          ("semi-sync", {"semi_sync_k": 3})])
def test_jetson_carry_path_with_damping_matches_reference(datasets, policy,
                                                          knobs):
    """The non-IID sweep's regime on jetson-mixed with churn: skew weights
    and non-IID damping on the carry path, divergence pinned at start."""
    ref, port = run_both(
        _stream_sources(datasets, 8, skew="dirichlet", alpha=0.05, seed=0),
        ROUNDS, weighted=True, policy=tbuf.TRUNCATION, base_lr=0.15,
        grad_floats=60.2e6, skew_weighting=True, noniid_damping=1.0,
        fleet=_fleets(profile="jetson-mixed", policy=policy, churn=True,
                      **knobs), **BASE)
    assert_same_history(ref, port)
    s = port.summary()
    assert s["fleet_mean_staleness"] > 0
    np.testing.assert_array_equal(port._pending_div, ref._pending_div)
    assert port.fleet.telemetry_summary()["mean_label_divergence"] > 0.1


def test_sharded_loader_short_batches_match_reference(datasets):
    """``on_arrivals`` into drop-oldest buffers small enough to evict, on a
    contiguous (skewed) placement, with a diurnal rate curve and churn:
    short and empty batches, identical ids and conservation counts."""
    jdata, tdata = datasets

    filled = []                 # per round: samples in each mask row

    def make():
        jld, tld = (mod.make_sharded_loader(
            data, 8, shards_per_device=2, skewed=True, max_buffer=24,
            evict=mod_buf.DROP_OLDEST, seed=0)
            for mod, data, mod_buf in ((jsd, jdata, jbuf),
                                       (tsd, tdata, tbuf)))
        draw = tld.batches

        def counted(rng, sizes, b_max, t_sim=0.0):
            xs, ys, masks = draw(rng, sizes, b_max, t_sim=t_sim)
            filled.append((masks.sum(axis=1), np.minimum(sizes, b_max)))
            return xs, ys, masks

        tld.batches = counted
        return jld, tld

    phase = np.linspace(0, 1, 8, endpoint=False)
    curve = (jsd.DiurnalCurve(day_s=40.0, amplitude=0.9, phase=phase),
             tsd.DiurnalCurve(day_s=40.0, amplitude=0.9, phase=phase))
    ref, port = run_both(
        make, ROUNDS, curve=curve, weighted=True, policy=tbuf.TRUNCATION,
        skew_weighting=True, noniid_damping=1.0,
        fleet=_fleets(profile="jetson-mixed", policy="semi-sync",
                      semi_sync_k=4, churn=True), **BASE)
    assert_same_history(ref, port)
    for p, r in zip(port.data.buffers, ref.data.buffers):
        assert (list(p._q), p.total_streamed, p.total_taken,
                p.total_dropped) == (list(r._q), r.total_streamed,
                                     r.total_taken, r.total_dropped)
    c = port.data.conservation()
    assert c == ref.data.conservation() and c["balanced"]
    assert c["dropped"] > 0
    # rows shorter than asked for, and rows with no sample, reached the step
    assert any((got < want).any() for got, want in filled)
    assert any((got == 0).any() for got, _ in filled)


def test_rotating_drift_with_diurnal_curve_matches_reference(datasets):
    """A time-aware source whose skew rotates on the sim clock, with a
    diurnal rate curve: the draw at ``t_sim`` and the divergence read after
    it, lockstep."""
    phase = np.linspace(0, 0.5, 8)
    curve = (jsd.compose_curves(jsd.DiurnalCurve(day_s=60.0, phase=phase)),
             tsd.compose_curves(tsd.DiurnalCurve(day_s=60.0, phase=phase)))
    ref, port = run_both(
        _stream_sources(datasets, 8, skew="shard", shards_per_device=1,
                        drift=dict(kind="rotate", t_scale=30.0, w_max=0.7),
                        seed=1),
        ROUNDS, curve=curve, weighted=True, skew_weighting=True,
        dist="S2", **{k: v for k, v in BASE.items() if k != "dist"})
    assert_same_history(ref, port)
    divs = [h["label_div_mean"] for h in port.history]
    assert len(set(divs)) > 2                      # divergence moves in time


def test_hill_climb_controller_sees_skew_like_reference(datasets):
    """The controller's divergence EWMA and its skew-biased probe order,
    inside a trainer run, in both packages."""
    ref, port = run_both(
        _stream_sources(datasets, 8, skew="shard", shards_per_device=1,
                        seed=0),
        ROUNDS, weighted=True, skew_weighting=True,
        fleet=_fleets(profile="jetson-mixed", controller="hill-climb",
                      controller_window=1, controller_probe_every=1),
        **BASE)
    assert_same_history(ref, port)
    pc, rc = port.fleet.controller, ref.fleet.controller
    assert pc.div_ewma == rc.div_ewma and pc._skewed() == rc._skewed()
    assert pc._skewed()
    assert [dataclasses.astuple(a) for a in pc.actions] == \
        [dataclasses.astuple(a) for a in rc.actions]


def _telemetry(cls, div):
    return cls(round_index=0, policy="async", knobs={}, dt=1.0,
               commit_time=1.0, n_started=4, n_participants=4, n_carried=0,
               n_dropped=0, n_crashed=0, committed_samples=64.0,
               committed_wait=0.0, mean_staleness=0.0, max_staleness=0,
               label_divergence=div)


@pytest.mark.parametrize("div,skewed", [(0.0, False), (0.9, True),
                                        (0.3, False)])
def test_controller_skew_bias_flips_probe_direction(div, skewed):
    out = []
    for mod, tel in ((tcontrol, RoundTelemetry), (jcontrol, JTelemetry)):
        ctrl = mod.HillClimbController(8, skew_threshold=0.35)
        for _ in range(10):
            ctrl.update(_telemetry(tel, div), 1.0)
        act = ctrl._propose_probe()
        out.append((ctrl.div_ewma, ctrl._skewed(), ctrl.ref_k, ctrl.cand_k,
                    None if act is None else dataclasses.astuple(act)))
    assert out[0] == out[1]
    assert out[0][1] == skewed
    if skewed:
        # under skew the first probe proposes a tighter barrier (k: 1 -> 2)
        assert out[0][4] is not None and out[0][3] > out[0][2]

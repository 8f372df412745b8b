"""The port's serving runtime against the JAX package, on the CPU.

* The carried-over host modules give identical results at equal seeds:
  ``RequestStream``/``BurstyRequestStream`` traces, ``StreamSimulator``
  rates, the event core's order, ``summarize`` and ``RollingWindow``.
* The pure-sim ``Scheduler`` gives summaries and records identical to the
  reference's across the chunk grid (None, 16, 64) and 1/2/4 runner lanes,
  as do the continuous and static servers and the ``PrefixSimRunner``
  shared-prefix cell (its win metrics included), and the tracker receives
  the same events.
* Real runners, greedy, on a reduced qwen2-0.5b: the port's fixed-slot and
  paged runners (prefix sharing off and on) generate the same tokens, and
  the same tokens as the reference's runner fed the same prompts.
* The paged admission protocol: ``insufficient_pages`` shedding, the
  reservation race, ``cancel_prefill`` unwinding; ``measured_cost_model``
  and the streaming launcher on the CPU.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import streams as jstreams  # noqa: E402
from repro.models import RunCtx as JaxCtx  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.obs import MemoryTracker as JaxMemoryTracker  # noqa: E402
from repro.sim import EventQueue as JaxEventQueue  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import streams as tstreams  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.transformer import RunCtx  # noqa: E402
from repro_torch.obs import MemoryTracker  # noqa: E402
from repro_torch.sim import EventQueue, SimClock  # noqa: E402

JCTX = JaxCtx(remat=False, chunk_q=8, chunk_k=8, kernel_interpret=False)
TCTX = RunCtx(device="cpu")

# the reference's stress cost model (tests/test_serve_scale.py)
COSTS = {pkg: pkg.StepCostModel(decode_step_s=0.01, prefill_token_s=5e-4,
                                prefill_base_s=2e-3)
         for pkg in (jserve, tserve)}


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN, through dicts, lists and tuples."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def _rows(records):
    return [dataclasses.astuple(r) for r in records]


def _reqs(pkg, kind, **kw):
    cls = pkg.RequestStream if kind == "stream" else pkg.BurstyRequestStream
    return cls(**kw)


STREAMS = [
    ("stream", dict(dist="S1", n_clients=6, seed=3), 10.0),
    ("stream", dict(dist="S2", n_clients=12, prompt_lens=(16, 64, 256),
                    max_new_tokens=16, slo_ttft_s=0.25, slo_tpot_s=0.05,
                    seed=0), 8.0),
    ("stream", dict(dist="S1p", n_clients=4, prompt_len=24,
                    max_new_tokens=6, seed=1, n_templates=3,
                    template_prefix_len=16), 6.0),
    ("bursty", dict(base_rate=30.0, burst_mult=4.0,
                    prompt_lens=(16, 64, 256), max_new_tokens=16,
                    slo_ttft_s=0.25, slo_tpot_s=0.05, seed=1), 8.0),
    ("bursty", dict(base_rate=10.0, seed=2, n_templates=2,
                    template_prefix_len=24, template_zipf=1.5), 5.0),
]


@pytest.mark.parametrize("kind,kw,horizon", STREAMS,
                         ids=[f"{s[0]}{i}" for i, s in enumerate(STREAMS)])
def test_request_streams_identical(kind, kw, horizon):
    j = _reqs(jserve, kind, **kw).generate(horizon)
    t = _reqs(tserve, kind, **kw).generate(horizon)
    assert len(t) > 0 and _rows(t) == _rows(j)


def test_stream_simulator_and_table_identical():
    assert tstreams.TABLE_I.keys() == jstreams.TABLE_I.keys()
    for name in tstreams.TABLE_I:
        assert (dataclasses.astuple(tstreams.TABLE_I[name])
                == dataclasses.astuple(jstreams.TABLE_I[name]))
        j = jstreams.StreamSimulator(jstreams.TABLE_I[name], 16, seed=4,
                                     intra_jitter=0.1,
                                     producer_contention=True)
        t = tstreams.StreamSimulator(tstreams.TABLE_I[name], 16, seed=4,
                                     intra_jitter=0.1,
                                     producer_contention=True)
        for step in range(5):
            np.testing.assert_array_equal(t.rates_at(step), j.rates_at(step))
    rates = np.array([12, 38, 300])
    np.testing.assert_array_equal(tstreams.streaming_latency(rates, 64),
                                  jstreams.streaming_latency(rates, 64))


def test_event_core_order_identical():
    pushes = [(0.5, "a", 1), (0.1, "b", 2), (0.5, "c", 3), (0.1, "d", 4),
              (0.3, "e", 5)]
    tq, jq = EventQueue(), JaxEventQueue()
    for p in pushes:
        tq.push(*p)
        jq.push(*p)
    assert ([(e.time, e.seq, e.kind, e.actor) for e in tq.drain()]
            == [(e.time, e.seq, e.kind, e.actor) for e in jq.drain()])
    clock = SimClock()
    clock.advance_to(1.0)
    clock.advance_to(1.0 - 1e-12)           # float jitter is tolerated
    with pytest.raises(ValueError, match="backwards"):
        clock.advance_to(0.5)
    with pytest.raises(ValueError, match="negative"):
        clock.advance_by(-1.0)


def test_summarize_and_rolling_window_identical():
    recs = {}
    for pkg in (jserve, tserve):
        rs = [pkg.RequestRecord(rid=i, arrival_s=0.1 * i,
                                deadline_s=0.1 * i + 1.0, target_tokens=4,
                                slo_ttft_s=0.3) for i in range(6)]
        for i, r in enumerate(rs):
            if i % 3 != 2:
                r.admit_s = r.arrival_s + 0.05 * i
                r.first_token_s = r.admit_s + 0.1
                r.tokens_out = 4 - i % 2
                r.finish_s = r.first_token_s + 0.2 * i
            else:
                r.dropped = "expired_in_queue"
        w = pkg.RollingWindow(2.0)
        events = []
        for t, g in ((0.5, 10), (1.0, 10), (4.0, 6), (3.0, 4)):
            w.record(t, g)
            events.append((w.n_events(t), w.goodput(t)))
        recs[pkg] = (pkg.summarize(rs, 3.0), events, _rows(rs))
    assert _same(recs[tserve], recs[jserve])


@pytest.mark.parametrize("n_runners", [1, 2, 4])
@pytest.mark.parametrize("chunk", [None, 16, 64])
def test_scheduler_sim_identical(chunk, n_runners):
    out = {}
    for pkg in (jserve, tserve):
        reqs = pkg.RequestStream(
            dist="S2", n_clients=12, prompt_lens=(16, 64, 256),
            max_new_tokens=16, slo_ttft_s=0.25, slo_tpot_s=0.05,
            seed=0).generate(6.0)
        res = []
        for prio in pkg.PRIORITIES:
            recs, s = pkg.Scheduler(4, COSTS[pkg], n_runners=n_runners,
                                    chunk_tokens=chunk,
                                    priority=prio).run(reqs, horizon_s=6.0)
            assert s["conservation_ok"]
            res.append((s, _rows(recs)))
        out[pkg] = res
    assert _same(out[tserve], out[jserve])


def test_continuous_and_static_servers_identical_with_events():
    out = {}
    for pkg, tracker in ((jserve, JaxMemoryTracker()),
                         (tserve, MemoryTracker())):
        reqs = pkg.RequestStream(
            dist="S2", n_clients=12, prompt_lens=(16, 64, 256),
            max_new_tokens=16, slo_ttft_s=0.25, slo_tpot_s=0.05,
            seed=0).generate(8.0)
        res = []
        for server in (pkg.ContinuousBatchingServer,
                       pkg.StaticBatchingServer):
            recs, s = server(4, COSTS[pkg], tracker=tracker).run(
                reqs, horizon_s=8.0)
            res.append((s, _rows(recs)))
        recs, s = pkg.Scheduler(4, COSTS[pkg], chunk_tokens=32,
                                tracker=tracker).run(reqs, horizon_s=8.0)
        res.append((s, _rows(recs)))
        out[pkg] = (res, tracker.records)
    assert any(r["data"].get("event") == "drop" for r in out[tserve][1])
    assert _same(out[tserve], out[jserve])


def test_shrinking_active_runners_identical():
    class Shrink:
        def tick(self, now, sched):
            if now >= 2.0 and sched.active_runners > 1:
                sched.set_active_runners(1)

    out = {}
    for pkg in (jserve, tserve):
        reqs = pkg.BurstyRequestStream(
            base_rate=30.0, prompt_lens=(16, 64, 256), max_new_tokens=16,
            slo_ttft_s=0.25, slo_tpot_s=0.05, seed=1).generate(6.0)
        recs, s = pkg.Scheduler(4, COSTS[pkg], n_runners=4,
                                chunk_tokens=32).run(
            reqs, horizon_s=6.0, controller=Shrink(), control_every_s=1.0)
        assert s["conservation_ok"] and s["active_runners"] == 1
        out[pkg] = (s, _rows(recs))
    assert _same(out[tserve], out[jserve])


def test_shared_prefix_sim_cell_identical():
    """The pure-sim Zipf cell of the reference: sharing-on serves at least
    as much as sharing-off at equal num_pages, with identical numbers in
    both packages."""
    out = {}
    for pkg in (jserve, tserve):
        reqs = pkg.RequestStream(
            dist="S2", n_clients=8, prompt_len=64, max_new_tokens=8,
            slo_ttft_s=0.5, slo_tpot_s=0.05, seed=0, n_templates=2,
            template_prefix_len=48).generate(4.0)
        res = {}
        for mode in (False, True):
            runner = pkg.PrefixSimRunner(8, 80, 8, 24, prefix_sharing=mode)
            recs, s = pkg.Scheduler(8, COSTS[pkg], runners=[runner],
                                    chunk_tokens=16).run(reqs, horizon_s=4.0)
            assert s["conservation_ok"] and runner.pool.conserved()
            res[mode] = (s, _rows(recs))
        out[pkg] = res
    assert _same(out[tserve], out[jserve])
    on, off = out[tserve][True][0], out[tserve][False][0]
    assert on["goodput_tok_s"] >= off["goodput_tok_s"]
    share = on["prefix_sharing"]
    assert share["prefix_hit_rate"] > 0 and share["pages_saved_frac"] > 0
    assert "prefix_sharing" not in off


# ---------------------------------------------------------------------------
# real runners on a reduced qwen2-0.5b


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(0), jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, device="cpu"))


def _trace(pkg, templates=0):
    return pkg.RequestStream(dist="S1", n_clients=4, prompt_lens=(8, 24),
                             max_new_tokens=6, slo_ttft_s=2.0,
                             slo_tpot_s=0.5, seed=0, n_templates=templates,
                             template_prefix_len=16).generate(3.0)


def _cost(pkg):
    return pkg.StepCostModel(decode_step_s=0.01, prefill_token_s=5e-4,
                             prefill_base_s=1e-3)


def test_real_runner_tokens_identical(model):
    """One template trace through the scheduler with chunked prefill: the
    port's fixed, paged and paged+sharing runners and the reference's fixed
    runner (fed the port's prompts) generate the same greedy tokens."""
    jcfg, jp, tcfg, tp = model

    def run(pkg, params, cfg, ctx, prompts=None, **kw):
        runner = pkg.SlotRunner(params, cfg, ctx, 2, 48, **kw)
        if prompts is not None:
            runner.prompt_tokens = prompts
        recs, s = pkg.Scheduler(2, _cost(pkg), runners=[runner],
                                chunk_tokens=8).run(_trace(pkg, 2),
                                                    horizon_s=3.0)
        assert s["conservation_ok"]
        return runner, s

    fixed, s_fixed = run(tserve, tp, tcfg, TCTX)
    assert fixed.ctx.decode_backend == "kernel"
    paged, _ = run(tserve, tp, tcfg, TCTX, page_size=16, num_pages=8)
    shared, s_shared = run(tserve, tp, tcfg, TCTX, page_size=8,
                           num_pages=16, prefix_sharing=True)
    ref, s_ref = run(jserve, jp, jcfg, JCTX, prompts=lambda req: jnp.asarray(
        fixed.prompt_tokens(req).numpy().astype(np.int32)))
    assert ref.ctx.decode_backend == "jax"
    assert len(fixed.generated) > 0
    for other in (paged, shared, ref):
        assert other.generated == fixed.generated
    share = s_shared["prefix_sharing"]
    assert share["hits"] > 0 and share["pages_saved"] > 0
    assert share["prefill_tokens_skipped"] > 0
    assert shared.pool.conserved() and paged.pool.conserved()
    assert _same(s_ref, s_fixed)


def test_prompts_come_from_numpy_streams(model):
    _, _, tcfg, tp = model
    runner = tserve.SlotRunner(tp, tcfg, TCTX, 2, 32, seed=5)
    a = tserve.Request(rid=7, arrival_s=0.0, prompt_len=12, max_new_tokens=2,
                       deadline_s=1.0)
    b = dataclasses.replace(a, rid=8, template=1, prefix_len=6)
    c = dataclasses.replace(a, rid=9, template=1, prefix_len=6)
    np.testing.assert_array_equal(
        runner.prompt_tokens(a)[0].numpy(),
        np.random.default_rng([5, 7]).integers(0, tcfg.vocab_size, 12))
    tb, tc_ = runner.prompt_tokens(b)[0], runner.prompt_tokens(c)[0]
    assert torch.equal(tb[:6], tc_[:6]) and not torch.equal(tb, tc_)
    assert tb.dtype == torch.int64 and tb.device.type == "cpu"


def test_insufficient_pages_sheds_oversized_request(model):
    _, _, tcfg, tp = model
    runner = tserve.SlotRunner(tp, tcfg, TCTX, 2, 32, page_size=8,
                               num_pages=2)
    big = tserve.Request(rid=0, arrival_s=0.0, prompt_len=16,
                         max_new_tokens=8, deadline_s=10.0, slo_ttft_s=10.0)
    assert not runner.can_admit(big)
    recs, s = tserve.Scheduler(2, COSTS[tserve], runners=[runner]).run(
        [big], horizon_s=1.0)
    assert s["conservation_ok"]
    assert recs[0].dropped == "insufficient_pages"
    assert runner.pool.conserved() and runner.pool.reserved == 0


def _req(rid, prompt_len=16, max_new=8, template=None, prefix_len=0):
    return tserve.Request(rid=rid, arrival_s=0.0, prompt_len=prompt_len,
                          max_new_tokens=max_new, deadline_s=100.0,
                          slo_ttft_s=100.0, template=template,
                          prefix_len=prefix_len)


def test_admission_reserves_pages(model):
    """A second ``can_admit`` sees the first one's reservation, so two
    overlapping admissions never count the same free pages."""
    _, _, tcfg, tp = model
    runner = tserve.SlotRunner(tp, tcfg, TCTX, 2, 32, page_size=8,
                               num_pages=4)
    r1, r2 = _req(1), _req(2)               # 3 pages each, pool of 4
    assert runner.can_admit(r1) and runner.pool.reserved == 3
    assert not runner.can_admit(r2)
    job = runner.start_prefill(r1)
    while not job.done:
        job.step(8)
    runner.finish_prefill(0, r1, job)
    assert runner.pool.reserved == 0 and runner.pool.in_use() == 3
    assert not runner.can_admit(r2)
    runner.release(0)
    assert runner.can_admit(r2) and runner.pool.conserved()


def test_cancel_prefill_unwinds_shared_refs(model):
    """Evicting a job mid-prefill returns its reservation and drops its
    shared-page refs without freeing pages the index still holds."""
    _, _, tcfg, tp = model
    runner = tserve.SlotRunner(tp, tcfg, TCTX, 2, 48, page_size=8,
                               num_pages=12, prefix_sharing=True)
    assert runner.prefix_index is not None
    donor = _req(1, 24, 6, template=0, prefix_len=16)
    assert runner.can_admit(donor)
    job = runner.start_prefill(donor)
    while not job.done:
        job.step(8)
    runner.finish_prefill(0, donor, job)    # donates 2 full prefix pages
    held = sorted(runner.prefix_index.held_pages())
    base = [runner.pool.refcount(p) for p in held]
    consumer = _req(2, 24, 6, template=0, prefix_len=16)
    assert runner.can_admit(consumer)
    assert sum(runner.pool.refcount(p) for p in held) > sum(base)
    job2 = runner.start_prefill(consumer)
    assert job2.done_tokens == 16           # prefill skipped the match
    runner.cancel_prefill(job2)
    assert runner.pool.reserved == 0
    assert [runner.pool.refcount(p) for p in held] == base
    runner.release(0)
    assert runner.pool.conserved()
    assert sorted(runner.prefix_index.held_pages()) == held


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_slot_runner_keeps_the_context_decode_backend(model, backend):
    """The runner decodes on ``ctx.decode_backend`` as given: no other
    setting overrides it."""
    _, _, tcfg, tp = model
    ctx = dataclasses.replace(TCTX, decode_backend=backend)
    runner = tserve.SlotRunner(tp, tcfg, ctx, 2, 48, page_size=8,
                               num_pages=12)
    assert runner.ctx.decode_backend == backend


def test_measured_cost_model_on_cpu(model):
    _, _, tcfg, tp = model
    cost = tserve.measured_cost_model(tp, tcfg, TCTX, 2, 24, 8, reps=2)
    assert cost.decode_step_s > 0 and cost.prefill_token_s > 0
    assert cost.prefill_base_s >= 0
    assert cost.prefill_chunk_s(4) == pytest.approx(
        cost.prefill_base_s + 4 * cost.prefill_token_s)


def test_streaming_launcher_on_cpu(tmp_path):
    ledger = tmp_path / "serve.jsonl"
    res = launch.run_streaming(launch.parse_args([
        "--reduced", "--device", "cpu", "--streaming", "--horizon", "1.5",
        "--clients", "4", "--prompt-len", "8", "--gen", "4",
        "--temperature", "0", "--track", str(ledger)]))
    s = res["summary"]
    assert s["n_requests"] > 0
    assert s["completed"] + s["dropped"] == s["n_requests"]
    assert res["runner"].device.type == "cpu"
    from repro_torch.obs import read_ledger
    kinds = {r["kind"] for r in read_ledger(str(ledger))}
    assert {"run_start", "serve_event", "serve_summary", "run_end"} <= kinds

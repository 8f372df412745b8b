"""The port's spans and counters (``repro_torch/obs/spans.py``) on the CPU.

Off (the default), the layer must be as if absent: the DDP steps and
``moe_ffn`` queue the same aten ops as with ``spans`` stubbed out, no
``record_function`` runs, no clock is read and no ``gc`` callback stays.
On, the training step queues the same aten ops (the spans only add
profiler marks) and ``moe_ffn`` adds only its counter's ops.  Then the
records themselves: self time under nesting, the instance cap, the
collector's passes with the span they interrupted, the MoE's routed,
assigned and capacity rows against the routing, the serving spans, and
``busy_by_span`` on synthetic profiler events.  Tiny configs: reduced
qwen2-0.5b (d 256, 2 layers) and reduced mixtral-8x22b (4 experts, top-2,
groups of 64).
"""
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models.transformer import RunCtx, init_params  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.requests import Request  # noqa: E402
from repro_torch.train import ddp, step as tstep  # noqa: E402
from repro_torch.train.ddp import make_ddp_steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN_SPANS = {"repro.train.step", "repro.train.forward",
               "repro.train.backward", "repro.train.aggregate",
               "repro.train.update"}
COUNTER_OPS = {"aten.count_nonzero.default", "aten.zeros.default",
               "aten.add_.Tensor"}


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


class _Ops(TorchDispatchMode):
    """Every op that reaches the dispatcher, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _recorded(fn):
    with _Ops() as rec:
        fn()
    return rec.ops


def _aten(ops):
    return [o for o in ops if o.startswith("aten.")]


_ABSENT = SimpleNamespace(span=lambda name: contextlib.nullcontext(),
                          enabled=lambda: False,
                          count=lambda name, n: None,
                          count_on_device=lambda name, t: None)


@contextlib.contextmanager
def _absent(monkeypatch):
    """The program with the spans layer stubbed out at every site."""
    with monkeypatch.context() as m:
        for mod in (ddp, tstep, tmoe, tdecode, engine):
            m.setattr(mod, "spans", _ABSENT)
        yield


@contextlib.contextmanager
def _untouchable(monkeypatch):
    """Fail on any clock read or ``record_function`` by the layer."""
    def boom(*a, **k):
        raise AssertionError("the spans layer touched a clock or a mark")
    with monkeypatch.context() as m:
        m.setattr(spans, "_clock", boom)
        m.setattr(torch.autograd.profiler, "record_function", boom)
        yield


# ---------------------------------------------------------------------------
# the training step


def _train_setup(kind, remat):
    cfg = get_config("qwen2-0.5b").reduced()
    ctx = RunCtx(device="cpu", loss_chunk=16, remat=remat)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    phases = []
    dense, compressed, _, _ = make_ddp_steps(
        cfg, ctx, lambda g, s, p, lr: topt.sgdm_update(g, s, p, lr=lr),
        lambda t: 1e-2, 0.1, params, on_phase=phases.append)
    fn = {"dense": dense, "compressed": compressed}[kind]

    def one():
        return fn(params, topt.sgdm_init(params), batch, torch.ones(1), 0)

    one()                                   # warm: nothing lazy is recorded
    phases.clear()
    return one, phases


STEPS = [("compressed", False), ("compressed", True), ("dense", False),
         ("dense", True)]
STEP_IDS = ["compressed", "compressed-remat", "dense", "dense-remat"]


@pytest.mark.parametrize("kind,remat", STEPS, ids=STEP_IDS)
def test_off_the_training_step_queues_the_ops_of_the_layer_absent(
        kind, remat, monkeypatch):
    one, _ = _train_setup(kind, remat)
    callbacks = list(gc.callbacks)
    with _absent(monkeypatch):
        absent = _recorded(one)
    with _untouchable(monkeypatch):
        off = _recorded(one)
    assert off == absent
    assert not [o for o in off if o.startswith("profiler.")]
    assert gc.callbacks == callbacks
    assert spans.snapshot()["spans"] == {}


@pytest.mark.parametrize("kind,remat", STEPS, ids=STEP_IDS)
def test_on_the_training_step_queues_the_same_aten_ops(kind, remat):
    one, phases = _train_setup(kind, remat)
    off = _recorded(one)
    off_phases = list(phases)
    phases.clear()
    with spans.recording():
        on = _recorded(one)
    assert _aten(on) == _aten(off)
    assert phases == off_phases                 # on_phase: same names, order
    assert [o for o in on if o.startswith("profiler.")]     # the marks
    snap = spans.snapshot()
    names = TRAIN_SPANS | ({"repro.train.topk"} if kind == "compressed"
                           else set())
    assert set(snap["spans"]) == names
    assert snap["spans"]["repro.train.step"]["parents"] == {"": 1}
    for name in names - {"repro.train.step"}:
        assert snap["spans"][name]["parents"] == {"repro.train.step": 1}
        assert snap["spans"][name]["count"] == 1
    step = snap["spans"]["repro.train.step"]
    inner = sum(snap["spans"][n]["total_s"] for n in names
                if n != "repro.train.step")
    assert step["self_s"] == pytest.approx(step["total_s"] - inner,
                                           abs=1e-9)
    assert step["total_s"] >= inner > 0


def test_the_phase_marks_keep_their_order_with_spans_on():
    """``on_phase`` sees each step's phases in the order it always has."""
    cfg = get_config("qwen2-0.5b").reduced()
    ctx = RunCtx(device="cpu", loss_chunk=16, remat=False)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.zeros((2, 16), dtype=torch.long)
             for k in ("tokens", "labels")}
    phases = []
    dense, compressed, _, _ = make_ddp_steps(
        cfg, ctx, lambda g, s, p, lr: topt.sgdm_update(g, s, p, lr=lr),
        lambda t: 1e-2, 0.1, params, on_phase=phases.append)
    with spans.recording():
        compressed(params, topt.sgdm_init(params), batch, torch.ones(1), 0)
        dense(params, topt.sgdm_init(params), batch, torch.ones(1), 0)
    assert phases == ["fwd_bwd", "topk", "aggregate", "update", "fwd_bwd",
                      "aggregate", "update"]
    assert spans.snapshot()["spans"]["repro.train.step"]["count"] == 2


def test_spans_sit_on_the_profilers_clock():
    """Each span is a ``record_function`` range in a profile, nested as
    the program nests them."""
    one, _ = _train_setup("dense", False)
    from torch.profiler import ProfilerActivity, profile
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        one()
    ranges = {e.name: e.time_range for e in p.events()
              if e.name.startswith(spans.PREFIX)}
    assert TRAIN_SPANS <= set(ranges)
    outer = ranges["repro.train.step"]
    for name in TRAIN_SPANS - {"repro.train.step"}:
        assert outer.start <= ranges[name].start <= ranges[name].end \
            <= outer.end


# ---------------------------------------------------------------------------
# the layer's own records


def _clock_from(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(spans, "_clock", lambda: next(it))


def test_nesting_gives_self_time(monkeypatch):
    spans.enable()
    _clock_from(monkeypatch, [0, 10, 30, 40, 45, 100, 200, 260])
    gc.disable()                    # no collector's pass reads the clock
    try:
        with spans.span("repro.a"):
            with spans.span("repro.b"):
                pass
            with spans.span("repro.c"):
                pass
        with spans.span("repro.b"):
            pass
    finally:
        gc.enable()
    snap = spans.snapshot()["spans"]
    assert snap["repro.a"] == {"count": 1, "total_s": pytest.approx(100e-9),
                               "self_s": pytest.approx(75e-9),
                               "parents": {"": 1}}
    assert snap["repro.b"]["count"] == 2
    assert snap["repro.b"]["total_s"] == pytest.approx(80e-9)
    assert snap["repro.b"]["self_s"] == pytest.approx(80e-9)
    assert snap["repro.b"]["parents"] == {"repro.a": 1, "": 1}
    assert snap["repro.c"]["parents"] == {"repro.a": 1}
    assert spans.snapshot()["instances"] == [
        ["repro.b", "repro.a", 10, 30], ["repro.c", "repro.a", 40, 45],
        ["repro.a", None, 0, 100], ["repro.b", None, 200, 260]]


def test_the_instance_cap_keeps_the_aggregates_exact(monkeypatch):
    monkeypatch.setattr(spans, "MAX_INSTANCES", 3)
    with spans.recording():
        for _ in range(5):
            with spans.span("repro.x"):
                pass
    snap = spans.snapshot()
    assert len(snap["instances"]) == 3 and snap["instances_dropped"] == 2
    assert snap["spans"]["repro.x"]["count"] == 5


def test_off_spans_and_counters_do_nothing(monkeypatch):
    with _untouchable(monkeypatch):
        ctx = spans.span("repro.x")
        assert ctx is spans.span("repro.y")         # one shared no-op
        with ctx:
            spans.count("moe.assigned_rows", 7)
            spans.count_on_device("moe.routed_rows", torch.tensor(3))
    snap = spans.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["gc"]["count"] == 0


def test_counters_add_up_and_reset_clears(monkeypatch):
    with spans.recording():
        spans.count("c.host", 2)
        spans.count("c.host", 3)
        spans.count_on_device("c.dev", torch.tensor(4))
        spans.count_on_device("c.dev", torch.count_nonzero(torch.ones(5)))
        with torch.inference_mode():
            spans.count_on_device("c.dev", torch.tensor(1))
    snap = spans.snapshot()
    assert snap["counters"] == {"c.host": 5, "c.dev": 10}
    json.dumps(snap)                                # plain values
    spans.reset()
    assert spans.snapshot()["counters"] == {}


def test_recording_restores_the_switch_and_the_gc_hooks():
    callbacks = list(gc.callbacks)
    with spans.recording():
        assert spans.enabled() and len(gc.callbacks) == len(callbacks) + 1
    assert not spans.enabled() and gc.callbacks == callbacks
    spans.enable()
    with spans.recording():
        pass
    assert spans.enabled()
    spans.disable()
    assert gc.callbacks == callbacks


def test_allocator_reads_nothing_without_a_card():
    with spans.recording():
        pass
    assert spans.snapshot()["allocator"] == {}


class _Cycle:
    def __init__(self):
        self.me = self


def test_a_forced_collection_is_recorded_with_the_span_it_interrupted():
    with spans.recording():
        with spans.span("repro.outer"):
            _Cycle()
            gc.collect()
        gc.collect(0)
    snap = spans.snapshot()
    first, second = snap["gc"]["passes"][-2:]
    assert first["span"] == "repro.outer" and first["generation"] == 2
    assert first["collected"] >= 2 and first["seconds"] > 0
    assert second["span"] is None and second["generation"] == 0
    assert snap["gc"]["by_generation"]["2"]["count"] >= 1
    assert snap["gc"]["seconds"] >= first["seconds"] + second["seconds"]
    json.dumps(snap)


def test_a_collection_is_a_repro_gc_mark_inside_its_span():
    """The collector's pass enters and leaves a ``repro.gc`` mark from
    inside the collector, under a profiler, and it lands inside the span
    it interrupted."""
    from torch.profiler import ProfilerActivity, profile
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        with spans.span("repro.outer"):
            _Cycle()
            gc.collect()
    ranges = {}
    for e in p.events():
        ranges.setdefault(e.name, []).append(e.time_range)
    (outer,) = ranges["repro.outer"]
    assert ranges[spans.GC_MARK]
    assert any(outer.start <= r.start <= r.end <= outer.end
               for r in ranges[spans.GC_MARK])


# ---------------------------------------------------------------------------
# the MoE's rows


def _moe(factor=None, b=2, s=128, seed=0):
    cfg = get_config("mixtral-8x22b").reduced()
    if factor is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    g = torch.Generator().manual_seed(seed)
    params = tmoe.init_moe(g, cfg, torch.float32, "cpu")
    x = torch.randn((b, s, cfg.d_model), generator=g)
    return cfg, params, x


def _combine(cfg, params, x):
    moe = cfg.moe
    S = min(moe.group_size, x.shape[1])
    xg = x.reshape(x.shape[0], -1, S, x.shape[2])
    return tmoe._route(xg, params["router"], moe, tmoe.capacity(moe))[0]


def test_moe_off_queues_the_ops_of_the_layer_absent(monkeypatch):
    cfg, params, x = _moe()
    with _absent(monkeypatch):
        absent = _recorded(lambda: tmoe.moe_ffn(params, x, cfg))
    with _untouchable(monkeypatch):
        off = _recorded(lambda: tmoe.moe_ffn(params, x, cfg))
    assert off == absent


def test_moe_on_adds_only_the_counters_ops():
    cfg, params, x = _moe()
    off = _recorded(lambda: tmoe.moe_ffn(params, x, cfg))
    with spans.recording():
        on = _aten(_recorded(lambda: tmoe.moe_ffn(params, x, cfg)))
    it = iter(on)
    assert all(op in it for op in off)  # off is a subsequence of on
    rest = list(on)
    for op in off:
        rest.remove(op)
    assert set(rest) <= COUNTER_OPS and "aten.count_nonzero.default" in rest


def test_routed_rows_are_the_dispatch_nonzeros_when_rows_drop():
    cfg, params, x = _moe(factor=0.25)           # C = 8 of a group of 64
    b, s = x.shape[:2]
    moe = cfg.moe
    S = min(moe.group_size, s)
    G, C = s // S, tmoe.capacity(moe)
    with spans.recording():
        y, _ = tmoe.moe_ffn(params, x, cfg)
    c = spans.snapshot()["counters"]
    routed = int((_combine(cfg, params, x) > 0).sum())
    assert c["moe.routed_rows"] == routed
    assert c["moe.assigned_rows"] == b * s * moe.top_k
    assert c["moe.capacity_rows"] == b * moe.num_experts * G * min(C, S)
    assert c["moe.routed_rows"] < c["moe.assigned_rows"]   # rows dropped
    assert routed <= c["moe.capacity_rows"]


@pytest.mark.parametrize("factor", [2.0, 4.0])
def test_nothing_drops_at_a_capacity_factor_of_e_over_top_k(factor):
    cfg, params, x = _moe(factor=factor)
    assert factor >= cfg.moe.num_experts / cfg.moe.top_k
    with spans.recording():
        tmoe.moe_ffn(params, x, cfg)
        tmoe.moe_ffn(params, x[:, :1], cfg)     # a decode step's group
    c = spans.snapshot()["counters"]
    assert c["moe.routed_rows"] == c["moe.assigned_rows"] == (
        2 * 129 * cfg.moe.top_k)
    # two groups of 64, then a decode step's group of one token
    C, E = tmoe.capacity(cfg.moe), cfg.moe.num_experts
    assert c["moe.capacity_rows"] == 2 * E * (2 * min(C, 64) + min(C, 1))


def test_a_decode_call_counts_one_capacity_row_an_expert():
    """A decode step's group is its one token: an expert takes at most one
    row of it, so the call runs b·E capacity rows whatever the factor."""
    cfg, params, x = _moe(factor=4.0, b=5, s=1)
    assert tmoe.capacity(cfg.moe) > 1
    with spans.recording():
        tmoe.moe_ffn(params, x, cfg)
    c = spans.snapshot()["counters"]
    assert c["moe.capacity_rows"] == 5 * cfg.moe.num_experts
    assert c["moe.routed_rows"] == c["moe.assigned_rows"] == 5 * cfg.moe.top_k


def test_the_moe_span_and_counters_follow_the_model_under_autograd():
    """Inside a training step (a MoE model's forward and backward) the
    ``moe_ffn`` span sits under the forward, once a layer."""
    cfg = get_config("mixtral-8x22b").reduced()
    ctx = RunCtx(device="cpu", loss_chunk=16, remat=False)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.zeros((2, 64), dtype=torch.long)
             for k in ("tokens", "labels")}
    loss_fn = tstep.make_loss_fn(cfg, ctx)
    with spans.recording():
        tstep.value_and_grad(loss_fn, params, batch)
    snap = spans.snapshot()
    moe = snap["spans"]["repro.model.moe_ffn"]
    assert moe["parents"] == {"repro.train.forward": cfg.num_layers}
    assert snap["counters"]["moe.assigned_rows"] == (
        cfg.num_layers * 2 * 64 * cfg.moe.top_k)


_MESH_RANK = textwrap.dedent(r"""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import (batch_specs, distribute, make_plan,
                                  make_run_ctx, param_specs)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import spans
    from repro_torch.train.step import make_loss_fn

    rank, store, shape = (int(sys.argv[1]), sys.argv[2],
                          tuple(json.loads(sys.argv[3])))
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    torch.set_num_threads(1)
    cfg = get_config("mixtral-8x22b").reduced()
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))
    mesh = make_test_mesh(shape, ("data", "model"), device="cpu")
    plan = make_plan(mesh)
    ctx = make_run_ctx(cfg, plan, compute_dtype=torch.float32,
                       param_dtype=torch.float32, remat=False, chunk_q=16,
                       chunk_k=16, loss_chunk=16, device="cpu")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
             for k in ("tokens", "labels")}
    p_d = distribute(params, param_specs(params, cfg, plan), mesh)
    b_d = distribute(batch, batch_specs(cfg, plan, batch,
                                        seq_sharded=ctx.seq_sharded), mesh)
    with spans.recording():
        make_loss_fn(cfg, ctx)(p_d, b_d)
    print(json.dumps(spans.snapshot()["counters"]))
""")


@pytest.mark.parametrize("shape,rows", [((2, 1), 2), ((1, 2), 4)],
                         ids=["data", "expert"])
def test_on_a_mesh_each_rank_counts_its_own_rows(shape, rows, tmp_path):
    """Two gloo ranks: with the batch over "data" a rank counts its 2 of 4
    rows; with the experts over "model" (rows whole on each rank) all 4."""
    script = tmp_path / "rank.py"
    script.write_text(_MESH_RANK)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         json.dumps(list(shape))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    cfg = get_config("mixtral-8x22b").reduced()
    moe, L = cfg.moe, cfg.num_layers
    C = tmoe.capacity(dataclasses.replace(moe, capacity_factor=2.0))
    for c in outs:
        assert c["moe.assigned_rows"] == L * rows * 64 * moe.top_k
        assert c["moe.capacity_rows"] == (L * rows * moe.num_experts
                                          * min(C, 64))
        assert c["moe.routed_rows"] == c["moe.assigned_rows"]


# ---------------------------------------------------------------------------
# serving


def test_the_serving_spans_and_the_rows_of_a_decode():
    cfg = get_config("mixtral-8x22b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    runner = engine.SlotRunner(params, cfg, RunCtx(device="cpu"), 2, 48,
                               page_size=8, num_pages=12)
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=20, max_new_tokens=4,
                    deadline_s=float("inf")) for i in range(2)]
    with spans.recording():
        for slot, req in enumerate(reqs):
            job = runner.start_prefill(req)
            while not job.done:
                job.step(8)
            runner.finish_prefill(slot, req, job)
        runner.step([0, 1])
    snap = spans.snapshot()
    sp, c = snap["spans"], snap["counters"]
    assert sp["repro.serve.prefill_chunk"]["count"] == 2 * 3    # 8, 8, 4
    assert sp["repro.serve.decode"]["count"] == 1
    assert sp["repro.serve.sample"]["parents"] == {"": 1}
    moe = sp["repro.model.moe_ffn"]
    L = cfg.num_layers
    assert moe["parents"] == {"repro.serve.prefill_chunk": 6 * L,
                              "repro.serve.decode": L}
    # a call's capacity is min(C, S): chunks of 8, 8 and 4 a prompt, then
    # one decode step of a token a slot
    C, E = tmoe.capacity(cfg.moe), cfg.moe.num_experts
    assert c["moe.assigned_rows"] == L * (2 * 20 + 2) * cfg.moe.top_k
    assert c["moe.capacity_rows"] == L * E * (
        2 * (min(C, 8) + min(C, 8) + min(C, 4)) + 2 * min(C, 1))
    assert c["moe.routed_rows"] == c["moe.assigned_rows"]      # no drop


# ---------------------------------------------------------------------------
# the device side of a profile


def _ev(name, a, b, device="DeviceType.CPU", id=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           time_range=SimpleNamespace(start=a, end=b))


def test_busy_by_span_on_synthetic_events():
    """Each device operation goes to the spans whose host range held its
    launch (the runtime call with its correlation id), whatever thread
    made it."""
    gpu = "DeviceType.CUDA"
    events = [
        _ev("repro.train.step", 0, 100),
        _ev("repro.train.forward", 0, 40),
        _ev("repro.train.backward", 40, 100),
        _ev("repro.train.forward", 150, 160),
        _ev("aten::mm", 4, 8, id=1),                   # an op's own id
        _ev("cudaLaunchKernel", 5, 6, id=11),
        _ev("cudaLaunchKernel", 10, 11, id=12),
        _ev("cudaMemsetAsync", 12, 13, id=13),
        _ev("cudaLaunchKernel", 50, 51, id=14),        # the autograd thread
        _ev("cuLaunchKernel", 60, 61, id=15),          # a ctypes kernel
        _ev("cudaLaunchKernel", 120, 121, id=16),      # in no span
        _ev("cudaLaunchKernel", 155, 156, id=17),
        _ev("gemm", 200, 230, gpu, id=11), _ev("gemm", 230, 250, gpu, id=12),
        _ev("fill", 250, 252, gpu, id=13), _ev("gemm", 252, 292, gpu, id=14),
        _ev("sgdm", 292, 295, gpu, id=15), _ev("add", 300, 302, gpu, id=16),
        _ev("add", 310, 317, gpu, id=17),
        _ev("mm", 400, 401, gpu, id=1),                # no launch with id 1
        _ev("repro.train.forward", 200, 252, gpu, id=11),   # a device range
    ]
    got = spans.busy_by_span(events)
    assert set(got) == {"repro.train.step", "repro.train.forward",
                        "repro.train.backward"}
    assert got["repro.train.forward"] == {
        "busy_s": pytest.approx(59e-6), "kernels": 4, "ranges": 2}
    assert got["repro.train.backward"] == {
        "busy_s": pytest.approx(43e-6), "kernels": 2, "ranges": 1}
    assert got["repro.train.step"]["kernels"] == 5
    assert got["repro.train.step"]["busy_s"] == pytest.approx(95e-6)


def test_busy_by_span_needs_the_host_in_the_profile():
    gpu = "DeviceType.CUDA"
    assert spans.busy_by_span([_ev("gemm", 0, 10, gpu, id=1),
                               _ev("repro.train.forward", 0, 10, gpu)]) == {}


def test_busy_by_span_reads_a_real_profile():
    """On a CPU profile of the training step every span is found, with no
    device operation."""
    one, _ = _train_setup("compressed", False)
    from torch.profiler import ProfilerActivity, profile
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        one()
    got = spans.busy_by_span(p.events())
    for name in TRAIN_SPANS | {"repro.train.topk"}:
        assert got[name] == {"busy_s": 0.0, "kernels": 0, "ranges": 1}

"""Traffic loop of the training cells: the port's DDP step on a stream of
fresh global batches.

Set-up builds one training object (``train/ddp.py::make_ddp_steps`` with
``optim/optimizers.py::sgdm_update`` as its update, the benchmark's weights
and the momentum state) and drives it from the seed through its first three
steps, on the stream's first three batches through the window's own call;
it keeps what ``correct`` compares (each step's loss, each leaf's momentum
after one step, each leaf's change after three) and hands the same object
to the window.  The window runs steps back to back, each on the stream's
next batch and ended by a synchronise, until ``--seconds`` have passed;
its length runs to the end of the step that crosses that time.  With
``--trace 1`` CUDA events at the step's phase marks (``on_phase``) time its
phases, and a span of ``trace_steps`` further steps runs under the
profiler.  Once the program's state is freed, the plain reference follows
the same three steps from the same weights and batches.

Workload keys: ``step`` ("compressed" or "dense"), ``batch``, ``seq``,
``cr``, ``lr``, ``momentum``, ``rates``, ``kernels``, ``trace_steps``,
``limits``.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict

import torch

from bench import checks, flops, program, trace, traffic
from bench import weights as W
from bench.reference.train import ddp_steps as reference_steps

SETUP_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _batch(rows, device):
    tokens, labels = rows
    return {"tokens": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def reference_readings(spec, rows=None, precision="f32"):
    """The reference's three steps from the seed's weights and batches."""
    wl, cfg = spec.wl, spec.cfg
    stream = traffic.train_batches(spec.seed, wl["batch"], wl["seq"],
                                   cfg["vocab_size"])
    batches = [tuple(_batch(next(stream), spec.device).values())
               for _ in range(SETUP_STEPS)]
    ref = reference_steps(
        cfg, W.make(cfg, spec.seed, spec.device), batches, lr=wl["lr"],
        momentum=wl["momentum"],
        cr=wl["cr"] if wl["step"] == "compressed" else None,
        rates=wl["rates"], n_steps=SETUP_STEPS, precision=precision,
        rows=rows)
    _sync(spec.device)
    return ref


def run(spec) -> dict:
    from repro_torch.optim import optimizers
    from repro_torch.train import ddp

    wl, cfg, dev = spec.wl, spec.cfg, spec.device
    mc, ctx = program.model_config(cfg), program.run_ctx(cfg, dev)
    program.prebuild(wl["kernels"], dev)
    weights = W.make(cfg, spec.seed, dev)
    program.check_params(cfg, weights)
    spec.log(f"kernels built or found, weights made on the card: "
             f"{time.time() - spec.t_start:.3f} s after start")

    marks = []
    timing = {"on": False}

    def on_phase(name):
        if timing["on"]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

    def opt_update(g, s, p, lr):
        return optimizers.sgdm_update(g, s, p, lr=lr,
                                      momentum=wl["momentum"])

    dense, compressed, k, n = ddp.make_ddp_steps(
        mc, ctx, opt_update, lambda step: wl["lr"], wl["cr"], weights,
        on_phase=on_phase)
    step_fn = {"dense": dense, "compressed": compressed}[wl["step"]]
    rates = torch.tensor(wl["rates"], dtype=torch.float32, device=dev)
    stream = traffic.train_batches(spec.seed, wl["batch"], wl["seq"],
                                   cfg["vocab_size"])
    state = {"p": weights, "s": optimizers.sgdm_init(weights), "i": 0}

    host = []       # per step: (host s to queue it, host s waiting on it)

    def one_step():
        batch = _batch(next(stream), dev)
        if timing["on"]:
            on_phase("start")
        t = time.perf_counter()
        state["p"], state["s"], m = step_fn(state["p"], state["s"], batch,
                                            rates, state["i"])
        t1 = time.perf_counter()
        state["i"] += 1
        _sync(dev)
        host.append((t1 - t, time.perf_counter() - t1))
        return m

    # set-up: the first steps, through the window's own call and feed
    got = {"loss": []}
    for i in range(SETUP_STEPS):
        got["loss"].append(float(one_step()["loss"]))
        if i == 0:
            got["first_grad"] = checks.leaf_norms(state["s"]["mom"])
    got["change"] = checks.leaf_norms(
        _tree_sub(state["p"], weights))
    del weights
    _sync(dev)
    setup_s = time.time() - spec.t_start
    spec.log(f"set-up {setup_s:.3f} s; losses {got['loss']}")

    # the window
    timing["on"] = spec.trace and dev.type == "cuda"
    allocs = _allocs(dev)
    host.clear()
    t0 = time.perf_counter()
    deadline, steps, walls = t0 + spec.seconds, 0, []
    while True:
        one_step()
        steps += 1
        t1 = time.perf_counter()
        walls.append(t1)
        if t1 >= deadline:
            break
    window_s = t1 - t0
    walls = [b - a for a, b in zip([t0] + walls, walls)]
    slow = sorted(zip(walls, host), reverse=True)[:3]
    walls = sorted(walls)
    queue_s, wait_s = (sorted(x) for x in zip(*host))
    spec.log(f"step wall ms: min {1e3 * walls[0]:.2f}, median "
             f"{1e3 * walls[len(walls) // 2]:.2f}, max {1e3 * walls[-1]:.2f}; "
             f"host ms a step to queue it: median "
             f"{1e3 * queue_s[len(walls) // 2]:.2f}, then waiting on it: "
             f"median {1e3 * wait_s[len(walls) // 2]:.2f}; the slowest "
             f"(wall, queue, wait) ms: "
             f"{[[round(1e3 * x, 2) for x in (w, *h)] for w, h in slow]}; "
             f"device allocations and frees in the window "
             f"{_allocs(dev) - allocs}")
    phase_ms = defaultdict(float)
    for (_, before), (name, ev) in zip(marks, marks[1:]):
        if name != "start":
            phase_ms[name] += before.elapsed_time(ev)
    timing["on"] = False
    per_step = flops.train_step(cfg, wl["batch"], wl["seq"])
    record = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
              "steps": steps, "tokens": steps * wl["batch"] * wl["seq"],
              "flops": steps * per_step, "phase_ms": dict(phase_ms),
              "phase_steps": steps if marks else 0, "n": n, "k": k,
              "dispatch_host_s": sum(queue_s),
              "step": wl["step"], "attempted": steps, "failed": 0}
    spec.log(f"window {window_s:.3f} s, {steps} steps")
    if spec.trace:
        span_steps = wl["trace_steps"]
        record["profile"] = trace.profile_span(
            lambda: [one_step() for _ in range(span_steps)], one_step, dev)
        record["profile"]["steps"] = span_steps
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)
    record["device_kind"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
    record["sound"] = all(x == x for x in got["loss"])

    # the program's state freed, the reference follows the same steps
    del state, step_fn, dense, compressed, stream
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(spec)
    record["compared"] = checks.compare_train(got, ref)
    record["reference"] = ref
    spec.log(f"reference {time.perf_counter() - t_ref:.3f} s; losses "
             f"{ref['loss']}")
    return record


def _allocs(device) -> int:
    if device.type != "cuda":
        return 0
    st = torch.cuda.memory_stats(device)
    return st.get("num_device_alloc", 0) + st.get("num_device_free", 0)


def _tree_sub(a, b):
    return {key: _tree_sub(a[key], b[key]) if isinstance(a[key], dict)
            else a[key] - b[key] for key in a}

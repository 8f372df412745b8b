"""Run one benchmark cell with the port's spans on, or time its step with
the spans on against off.

    python3 spans_probe.py --workload <cell> --seed <n> --seconds <s>
    python3 spans_probe.py --workload <cell> --seed <n> --seconds <s> --cost

Run from the root of a checkout on a CUDA card, like ``bench/run.py``.  It
drives the cell through the benchmark's own driver (``bench/drivers/``),
unchanged, and hooks it from outside:

* default: spans on (``repro_torch/obs/spans.py``) from the end of set-up,
  through the window and the traced span that follows (``--trace 1``).
  It prints the window's spans, counters, collector passes and allocator
  counts; the slowest steps with the collector's pauses in each; each
  span's device seconds and operations (``spans.busy_by_span``) in the
  labelled span's one iteration (the device-only span holds no host
  ranges); that span's idle gaps named by the innermost ``repro.*`` span
  (``bench.* > repro.* > op``), with the ``repro.*`` marks kept out of the
  device's busy time; and the quantities a per-layer metric of each would
  read.  The cell's own metrics are read as ``bench/run.py`` reads them.
* ``--cost``: the window's steps (the training step, or the serving
  runner's decode step) alternate in blocks of four, spans off, on, on,
  off, ...; it prints the host seconds of each call and its wall seconds
  (to its synchronise) by mode.

The last line of standard output is one JSON object; with ``--out DIR`` the
full record is also written to ``DIR/<cell>.<seed>[.cost].json``.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOCK = 4


def _setup_paths() -> None:
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    sys.path[0] = ROOT
    sys.path.insert(1, os.path.join(ROOT, "src"))


def _label(t, host):
    """``bench.* > repro.* > op``: the outermost ``bench.*`` mark, the
    innermost ``repro.*`` span and the innermost host operation at t."""
    covering = [(b - a, name) for a, b, name in host if a <= t <= b]
    spans_at = sorted((d, n) for d, n in covering if n.startswith("repro."))
    rest = [(a, b, n) for a, b, n in host if not n.startswith("repro.")]
    label = _ORIG["label"](t, rest)
    if not spans_at:
        return label
    mark, _, op = label.partition(" > ")
    return f"{mark} > {spans_at[0][1]} > {op}"


def _is_device(e) -> bool:
    return _ORIG["is_device"](e) and not e.name.startswith("repro.")


_ORIG = {}      # the harness's own functions that probe_spans patches


def _per_step(values, steps):
    return 1e3 * values / steps if steps else None


def probe_spans(spec, bm):
    """Drive the cell with spans on from the end of set-up; the record,
    the window's snapshot and what the traced span showed."""
    from bench import harness, trace
    from repro_torch.obs import spans

    got = {}
    log = spec.log

    def hook(msg):
        if msg.startswith("set-up"):
            spans.reset()
            spans.enable()
        elif "window" not in got and msg.startswith(("step wall", "window")):
            got["window"] = spans.snapshot()
            spans.reset()
        log(msg)

    if not _ORIG:
        _ORIG.update(label=trace._label, is_device=trace._is_device,
                     profile=trace._profile, span=trace.profile_span)
    trace._label, trace._is_device = _label, _is_device
    profiles = []

    def profile(fn, device, host):
        events, seconds = _ORIG["profile"](fn, device, host)
        profiles.append((host, events))
        return events, seconds

    def profile_span(span, labelled, device):
        profiles.clear()
        out = _ORIG["span"](span, labelled, device)
        spans.disable()
        # the device-only span has no host ranges: the labelled one's
        events = next(ev for host, ev in profiles if host)
        out["by_span"] = spans.busy_by_span(events)
        out["by_span_steps"] = 1
        device = [e.time_range.end - e.time_range.start for e in events
                  if _is_device(e)]
        out["labelled_device"] = {"ops": len(device),
                                  "busy_s": sum(device) * 1e-6}
        return out

    trace._profile, trace.profile_span = profile, profile_span
    spec.log = hook
    driver = harness.load_module("drivers", spec.wl["driver"])
    record = driver.run(spec)
    spans.disable()
    metrics = {}
    for m in harness.metrics_for(bm, spec.cell, 1):
        value = harness.load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = float(value)
    return record, got.get("window", {}), metrics


def read_spans(record, win):
    """The quantities the new per-layer metrics would read, and the log
    lines the drivers would print."""
    steps = record.get("steps", 0)
    sp, gcs = win.get("spans", {}), win.get("gc", {})
    prof = record.get("profile", {})
    by_span, pst = prof.get("by_span", {}), prof.get("by_span_steps")
    out, lines = {}, []

    def host_ms(name):
        return _per_step(sp[name]["total_s"], steps) if name in sp else None

    def busy_ms(name):
        if name not in by_span or not pst:
            return None
        return 1e3 * by_span[name]["busy_s"] / pst

    if record.get("kind") == "train":
        out["forward_host_ms.train"] = host_ms("repro.train.forward")
        out["backward_host_ms.train"] = host_ms("repro.train.backward")
        out["gc_pause_ms.train"] = _per_step(gcs.get("seconds", 0.0), steps)
        out["forward_busy_ms.train"] = busy_ms("repro.train.forward")
        out["backward_busy_ms.train"] = busy_ms("repro.train.backward")
        for name in sorted(sp):
            out[f"host_ms.{name}"] = host_ms(name)
            out[f"self_ms.{name}"] = _per_step(sp[name]["self_s"], steps)
        lines.append(_slowest(win))
    else:
        c = win.get("counters", {})
        if c.get("moe.capacity_rows"):
            out["moe_capacity_util.serve"] = (
                100.0 * c["moe.routed_rows"] / c["moe.capacity_rows"])
        out["decode_dispatch_ms.serve"] = host_ms("repro.serve.decode")
        out["sample_ms.serve"] = host_ms("repro.serve.sample")
        if "repro.serve.prefill_chunk" in sp:
            ch = sp["repro.serve.prefill_chunk"]
            out["prefill_chunk_ms.serve"] = 1e3 * ch["total_s"] / ch["count"]
        lines.append(
            f"MoE rows in the window: routed {c.get('moe.routed_rows')}, "
            f"capacity {c.get('moe.capacity_rows')}, assigned "
            f"{c.get('moe.assigned_rows')}, dropped "
            f"{c.get('moe.assigned_rows', 0) - c.get('moe.routed_rows', 0)}")
    for name in sorted(by_span):
        b = by_span[name]
        lines.append(f"{name}: {b['kernels'] / pst:.1f} kernels a step, "
                     f"busy {1e3 * b['busy_s'] / pst:.3f} ms a step "
                     f"({b['ranges']} ranges)")
    if prof.get("labelled_device"):
        d = prof["labelled_device"]
        lines.append(f"labelled span: {d['ops']} device operations, "
                     f"{1e3 * d['busy_s']:.3f} ms")
    lines.append(f"collector in the window: {gcs.get('count')} passes, "
                 f"{1e3 * gcs.get('seconds', 0.0):.3f} ms, by generation "
                 f"{gcs.get('by_generation')}; allocator "
                 f"{win.get('allocator')}")
    return out, lines


def _slowest(win, top=5):
    """The slowest steps of the window (start to next start), each with
    the host ms of its child spans and the collector's pauses inside it:
    passes by generation, their ms, the longest and the span it
    interrupted."""
    inst = win.get("instances", [])
    starts = sorted(i[2] for i in inst if i[0] == "repro.train.step")
    passes = win.get("gc", {}).get("passes", [])
    rows = []
    for a, b in zip(starts, starts[1:]):
        gcs = [p for p in passes if a <= p["start_ns"] < b]
        kids = {}
        for name, parent, c, d in inst:
            if parent == "repro.train.step" and a <= c < b:
                kids[name.rsplit(".", 1)[-1]] = round((d - c) * 1e-6, 2)
        by_gen = {}
        for p in gcs:
            by_gen[p["generation"]] = by_gen.get(p["generation"], 0) + 1
        worst = max(gcs, key=lambda p: p["seconds"], default=None)
        rows.append(((b - a) * 1e-6, kids, by_gen, sum(
            p["seconds"] for p in gcs) * 1e3, worst))
    rows.sort(key=lambda r: -r[0])
    parts = []
    for ms, kids, by_gen, gc_ms, worst in rows[:top]:
        w = (f", longest {worst['seconds'] * 1e3:.2f} ms (gen "
             f"{worst['generation']}, in {worst['span']})" if worst else "")
        parts.append(f"{ms:.2f} ms {kids}: collector {gc_ms:.2f} ms in "
                     f"passes by generation {by_gen}{w}")
    return "slowest steps (start to next start): " + "; ".join(parts)


def probe_cost(spec):
    """The cell's window with its steps alternating spans off and on in
    blocks of ``BLOCK``: per mode, host seconds of each call and wall
    seconds to its synchronise."""
    import torch
    from bench import harness
    from repro_torch.obs import spans
    from repro_torch.serve import engine
    from repro_torch.train import ddp

    calls = {"off": [], "on": []}
    state = {"n": 0, "window": False}
    log = spec.log

    def hook(msg):
        if msg.startswith("set-up"):
            state["window"] = True
        elif msg.startswith(("step wall", "window")):
            state["window"] = False
        log(msg)

    def timed(fn):
        def call(*a, **k):
            if not state["window"]:
                return fn(*a, **k)
            i = state["n"]
            state["n"] += 1
            on = (i // BLOCK) % 4 in (1, 2)
            if on:
                spans.enable()
            t = time.perf_counter()
            out = fn(*a, **k)
            t1 = time.perf_counter()
            if spec.device.type == "cuda":
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            if on:
                spans.disable()
            calls["on" if on else "off"].append((t1 - t, t2 - t))
            return out
        return call

    make = ddp.make_ddp_steps

    def make_timed(*a, **k):
        dense, compressed, kk, n = make(*a, **k)
        return timed(dense), timed(compressed), kk, n

    ddp.make_ddp_steps = make_timed
    engine.SlotRunner.step = timed(engine.SlotRunner.step)
    spec.log = hook
    driver = harness.load_module("drivers", spec.wl["driver"])
    driver.run(spec)
    out = {}
    for mode, xs in calls.items():
        if xs:
            out[mode] = {"calls": len(xs),
                         "host_ms_median": 1e3 * statistics.median(
                             x[0] for x in xs),
                         "wall_ms_median": 1e3 * statistics.median(
                             x[1] for x in xs),
                         "host_ms_mean": 1e3 * statistics.fmean(
                             x[0] for x in xs),
                         "wall_ms_mean": 1e3 * statistics.fmean(
                             x[1] for x in xs)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out", help="a directory for the full record")
    args = ap.parse_args()
    _setup_paths()
    import torch
    from bench import harness
    bm, entry, wl, cfg = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("spans_probe: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    spec = harness.Spec(cell=args.workload, wl=wl, cfg=cfg, seed=args.seed,
                        seconds=args.seconds, trace=0 if args.cost else 1,
                        device=torch.device("cuda", 0), t_start=T_START)
    card = (torch.cuda.get_device_name(0),
            os.popen("nvidia-smi --query-gpu=power.limit "
                     "--format=csv,noheader").read().strip())
    if args.cost:
        result = {"cell": args.workload, "seed": args.seed, "card": card,
                  "cost": probe_cost(spec)}
        full = result
    else:
        record, win, metrics = probe_spans(spec, bm)
        read, lines = read_spans(record, win)
        for line in lines:
            print(f"spans_probe: {line}", file=sys.stderr)
        prof = record.get("profile", {})
        result = {"cell": args.workload, "seed": args.seed, "card": card,
                  "steps": record.get("steps"),
                  "window_s": record.get("window_s"),
                  "spans_read": read, "metrics": metrics,
                  "counters": win.get("counters"),
                  "allocator": win.get("allocator"),
                  "gc": {k: v for k, v in win.get("gc", {}).items()
                         if k != "passes"},
                  "by_span": prof.get("by_span"),
                  "labelled_device": prof.get("labelled_device"),
                  "busy_s": prof.get("busy_s"),
                  "idle_gaps": prof.get("breakdown", {}).get("idle_gaps"),
                  "compared": record.get("compared")}
        full = dict(result, window=win, log=lines)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"{args.workload}.{args.seed}{'.cost' if args.cost else ''}"
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(full, f, default=str)
    print(json.dumps(result, default=str), flush=True)


if __name__ == "__main__":
    main()

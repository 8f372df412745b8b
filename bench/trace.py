"""Profiled spans of a run and what the per-layer metrics read from them.

Tracing the host's operations costs the host a few microseconds an
operation, which leaves a launch-bound device idle where it would not be.
So a run traces twice, after its window:

* ``device span``: the cell's own loop for a few iterations with the
  device's activity alone (kernels, copies, fills): the seconds in which an
  operation ran on the device (the union of their intervals), the span's
  length on the host clock, and each device operation's time by name;
* ``labelled span``: one or two more iterations with the host's operations
  too, inside a ``bench.span`` mark: the longest idle gaps of the device
  there, each named by what the host was doing at its middle (the
  innermost host operation, under the traffic loop's own ``bench.*``
  mark).  Its gaps are as long as they are under that heavier tracing.

No trace file is written.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

from bench.stats import union_length

SPAN = "bench.span"
TOP = 10


def _is_device(e) -> bool:
    """A kernel, copy or fill on the device; not the device-side copy of a
    ``record_function`` mark."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def _profile(fn: Callable[[], None], device: torch.device, host: bool):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return prof.events(), seconds


def profile_span(span: Callable[[], None], labelled: Callable[[], None],
                 device: torch.device) -> Dict:
    events, seconds = _profile(span, device, host=False)
    intervals, by_name = [], defaultdict(float)
    for e in events:
        if _is_device(e):
            a, b = e.time_range.start, e.time_range.end
            by_name[e.name] += (b - a) * 1e-6
            intervals.append((a, b))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": union_length(intervals) * 1e-6, "window_s": seconds,
            "device_s": dict(by_name),
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle_gaps(
                              _profile(labelled, device, host=True)[0])}}


def _label(t: float, host: List[Tuple[float, float, str]]) -> str:
    """The innermost host operation running at time t, under the
    outermost ``bench.*`` mark that holds it."""
    covering = [(b - a, name) for a, b, name in host if a <= t <= b]
    marks = sorted((-d, n) for d, n in covering
                   if n.startswith("bench.") and n != SPAN)
    ops = sorted((d, n) for d, n in covering if not n.startswith("bench."))
    mark = marks[0][1] if marks else SPAN
    op = ops[0][1] if ops else "python (no operation)"
    return f"{mark} > {op}"


def idle_gaps(events) -> List[list]:
    """The longest idle gaps of the device inside the ``bench.span`` mark,
    [label, seconds], longest first."""
    spans = [e for e in events if e.name == SPAN and not _is_device(e)
             and not str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not spans:
        raise RuntimeError("the profiler recorded no bench.span")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                device.append((a, b))
        elif e.name != SPAN and not str(
                getattr(e, "device_type", "")).endswith("CUDA"):
            host.append((a, b, e.name))
    gaps, end = [], lo
    for a, b in sorted(device):
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((hi - end, end, hi))
    gaps.sort(reverse=True)
    return [[_label((a + b) / 2, host), length * 1e-6]
            for length, a, b in gaps[:TOP]]


def kernel_seconds(profile: Dict, *names: str) -> float:
    """Device seconds of the operations whose name holds any of ``names``."""
    return sum(s for n, s in profile["device_s"].items()
               if any(x in n for x in names))

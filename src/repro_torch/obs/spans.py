"""Spans and counters at the port's layer boundaries, off by default.

The program marks its layer boundaries with ``span(name)`` (a context) and
counts with ``count(name, n)`` (host integers) and ``count_on_device(name,
t)`` (a device scalar added into a device-resident accumulator, no sync).
Nothing records until :func:`enable` (or inside :func:`recording`); turned
off, ``span`` returns one shared no-op context and a counter call returns at
once: no clock read, no ``record_function``, no ``gc`` callback, no aten op.

Turned on, each span:

* keeps, by name, its count, its host seconds in all and on its own (less
  its child spans, kept on one stack: the layer assumes one thread) and
  how often each parent held it;
* keeps its instances ``(name, parent, start_ns, end_ns)`` on the host's
  ``perf_counter_ns`` clock, up to ``MAX_INSTANCES`` (the aggregates stay
  exact past the cap);
* enters ``torch.profiler.record_function(name)``, which records nothing
  unless a profiler runs, and then sits on the profiler's clock beside the
  operations the span queued.

While on, a ``gc.callbacks`` hook records each pass of the cyclic
collector (generation, seconds, objects collected, the span it
interrupted) and marks it ``repro.gc`` on the profiler's clock.  The
caching allocator's retries, device allocations and device frees are read
at :func:`reset` and again at :func:`snapshot`, which returns it all as a
plain dict (device counters read there, once).  :func:`busy_by_span`
reads a profile: each span's device seconds and operations.

Sites (the span's name, then the counters):

* ``repro.train.step`` (``train/ddp.py``, each step's body), inside it
  ``repro.train.forward`` and ``repro.train.backward``
  (``train/step.py::value_and_grad``; the backward includes remat's
  recomputed forward), ``repro.train.topk``, ``repro.train.aggregate``,
  ``repro.train.update`` (the regions ``on_phase``'s marks close);
* ``repro.model.moe_ffn`` (``models/moe.py::moe_ffn``): ``moe.assigned_rows``
  (b·G·S·top_k, host), ``moe.capacity_rows`` (b·E·G·min(C, S), host),
  ``moe.routed_rows`` (the dispatch tensor's nonzeros, device; a rank's
  own rows on a mesh): rows dropped = assigned - routed;
* ``repro.serve.decode`` and ``repro.serve.sample``
  (``serve/engine.py::SlotRunner.step``), ``repro.serve.prefill_chunk``
  (``models/decode.py::ChunkedPrefill.step``).
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "repro."
GC_MARK = "repro.gc"
MAX_INSTANCES = 100_000
ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")
# the host's CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...) that queue device work
_RUNTIME = "cu"

_clock = time.perf_counter_ns
_on = False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _State:
    """What has been recorded since the last :func:`reset`."""

    def __init__(self):
        self.stack: List[_Span] = []
        self.spans: Dict[str, list] = {}     # name -> [n, total, self, parents]
        self.instances: List[Tuple] = []
        self.instances_dropped = 0
        self.counts: Dict[str, int] = {}
        self.device: Dict[str, torch.Tensor] = {}
        self.gc_passes: List[Dict[str, Any]] = []
        self.gc_by_gen: Dict[int, list] = {}  # gen -> [n, ns, collected]
        self.gc_open: Optional[Tuple] = None
        self.alloc_base: Optional[Dict[str, int]] = _alloc_stats()


def _alloc_stats() -> Optional[Dict[str, int]]:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    st = torch.cuda.memory_stats()
    return {k: int(st.get(k, 0)) for k in ALLOC_KEYS}


class _Span:
    __slots__ = ("name", "mark", "start", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mark = torch.autograd.profiler.record_function(self.name)
        self.mark.__enter__()
        self.child = 0
        _st.stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        stack = _st.stack
        if stack and stack[-1] is self:     # else a reset() came in between
            stack.pop()
            total = end - self.start
            parent = stack[-1].name if stack else None
            if stack:
                stack[-1].child += total
            agg = _st.spans.get(self.name)
            if agg is None:
                agg = _st.spans[self.name] = [0, 0, 0, {}]
            agg[0] += 1
            agg[1] += total
            agg[2] += total - self.child
            agg[3][parent] = agg[3].get(parent, 0) + 1
            if len(_st.instances) < MAX_INSTANCES:
                _st.instances.append((self.name, parent, self.start, end))
            else:
                _st.instances_dropped += 1
        self.mark.__exit__(*exc)
        return False


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    """``gc.callbacks`` hook: each pass's interval, generation, objects
    collected and the span it interrupted, and a ``repro.gc`` mark."""
    if phase == "start":
        mark = torch.autograd.profiler.record_function(GC_MARK)
        mark.__enter__()
        where = _st.stack[-1].name if _st.stack else None
        _st.gc_open = (mark, where, _clock())
        return
    if _st.gc_open is None:
        return
    end = _clock()
    mark, where, start = _st.gc_open
    _st.gc_open = None
    mark.__exit__(None, None, None)
    gen, collected = int(info.get("generation", -1)), int(
        info.get("collected", 0))
    agg = _st.gc_by_gen.setdefault(gen, [0, 0, 0])
    agg[0] += 1
    agg[1] += end - start
    agg[2] += collected
    if len(_st.gc_passes) < MAX_INSTANCES:
        _st.gc_passes.append({
            "generation": gen, "seconds": (end - start) * 1e-9,
            "collected": collected,
            "uncollectable": int(info.get("uncollectable", 0)),
            "span": where, "start_ns": start, "end_ns": end})


_st = _State()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording (spans, counters, the collector's passes)."""
    global _on
    if not _on:
        _on = True
        gc.callbacks.append(_on_gc)


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_on_gc)
        if _st.gc_open is not None:     # disabled inside a pass
            _st.gc_open[0].__exit__(None, None, None)
            _st.gc_open = None


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record inside the block, from a :func:`reset`, then restore the
    switch as it was."""
    was = _on
    reset()
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def reset() -> None:
    """Clear every record and take the allocator's counts as the base."""
    global _st
    if _st.gc_open is not None:
        _st.gc_open[0].__exit__(None, None, None)
    _st = _State()


def span(name: str):
    """A context that records ``name`` while on, and does nothing off."""
    return _Span(name) if _on else _NOOP


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` (while on)."""
    if _on:
        _st.counts[name] = _st.counts.get(name, 0) + int(n)


def count_on_device(name: str, t: torch.Tensor) -> None:
    """Add the integer scalar ``t`` into ``name``'s accumulator on ``t``'s
    device (while on), without a synchronise; read at :func:`snapshot`."""
    if not _on:
        return
    acc = _st.device.get(name)
    with torch.no_grad():
        if acc is None:
            with torch.inference_mode(False):
                acc = torch.zeros((), dtype=torch.int64, device=t.device)
            _st.device[name] = acc
        acc.add_(t if t.device == acc.device else t.to(acc.device))


def snapshot() -> Dict[str, Any]:
    """Everything recorded since :func:`reset`, as plain Python values:
    ``spans`` (name -> ``count``, ``total_s``, ``self_s``, ``parents``:
    parent name, or "" at the top, -> count), ``instances`` ([name,
    parent, start_ns, end_ns]) and ``instances_dropped``, ``counters``
    (host and device), ``gc`` (``passes``, the first ``MAX_INSTANCES``,
    and by generation ``count``, ``seconds``, ``collected``; ``seconds``
    and ``count`` in all) and ``allocator`` (the change of each of
    ``ALLOC_KEYS``; empty without a CUDA base)."""
    spans = {name: {"count": n, "total_s": tot * 1e-9, "self_s": own * 1e-9,
                    "parents": {p or "": c for p, c in parents.items()}}
             for name, (n, tot, own, parents) in _st.spans.items()}
    counters = dict(_st.counts)
    counters.update({name: int(acc.item())
                     for name, acc in _st.device.items()})
    by_gen = {str(g): {"count": n, "seconds": ns * 1e-9, "collected": c}
              for g, (n, ns, c) in sorted(_st.gc_by_gen.items())}
    now, base = _alloc_stats(), _st.alloc_base
    alloc = ({k: now[k] - base[k] for k in ALLOC_KEYS}
             if now is not None and base is not None else {})
    return {"spans": spans,
            "instances": [list(i) for i in _st.instances],
            "instances_dropped": _st.instances_dropped,
            "counters": counters,
            "gc": {"passes": [dict(p) for p in _st.gc_passes],
                   "by_generation": by_gen,
                   "count": sum(v["count"] for v in by_gen.values()),
                   "seconds": sum(v["seconds"] for v in by_gen.values())},
            "allocator": alloc}


def busy_by_span(events, prefix: str = PREFIX) -> Dict[str, Dict[str, Any]]:
    """Each ``prefix`` span's device work in a profile of the host and the
    device: the operations (kernels, copies, fills) whose launch (the
    runtime call with the operation's correlation id) the host made inside
    one of the span's host ranges, on any thread (the autograd engine
    launches the backward from its own, so the span's device range misses
    it); their device seconds (summed: one stream's operations do not
    overlap) and their count.  A profile of the device alone holds no host
    ranges and gives ``{}``."""
    ranges, launched, ops = defaultdict(list), {}, []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if not e.name.startswith(prefix):
                ops.append((e.id, b - a))
        elif e.name.startswith(prefix):
            ranges[e.name].append((a, b))
        elif e.name.startswith(_RUNTIME):
            launched[e.id] = a
    out = {}
    for name, rs in sorted(ranges.items()):
        rs.sort()
        starts = [a for a, _ in rs]
        n, us = 0, 0.0
        for cid, dur in ops:
            t = launched.get(cid)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= rs[i][1]:
                n += 1
                us += dur
        out[name] = {"busy_s": us * 1e-6, "kernels": n, "ranges": len(rs)}
    return out

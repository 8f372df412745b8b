"""torch.profiler capture windows around the hot paths.

Counterpart of ``repro/obs/profile.py``: thin, failure-tolerant wrappers
over ``torch.profiler.profile``.  A capture that cannot start (profiler
missing, a second capture already running) degrades to a no-op instead of
failing the run: profiling is observability, and observability must never
take the workload down.  A capture that records no device time (as on a
card whose CUPTI tracing is closed to the process) is still a capture.

* :func:`capture` — context manager; yields True iff a trace is recording,
  and writes a Chrome trace (``trace_<ns>.json``) under ``logdir`` on exit.
* :func:`capture_step` — run a callable once to warm up, then ``reps``
  times under a capture window; returns the trace directory, or None when
  skipped.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable, Iterator, Optional, Sequence

import torch


def profiler_available() -> bool:
    """Whether ``torch.profiler.profile`` exists on this install."""
    try:
        import torch.profiler
    except ImportError:
        return False
    return hasattr(torch.profiler, "profile")


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def capture(logdir: Optional[str], enabled: bool = True) -> Iterator[bool]:
    """Profiler capture window writing to ``logdir``.

    Yields True while a trace is recording; yields False (and runs the body
    untraced) when disabled, ``logdir`` is None, or the profiler is
    unavailable or cannot start.  Exceptions from the body propagate;
    exceptions from the profiler itself never do (they become warnings).
    """
    if not enabled or logdir is None or not profiler_available():
        yield False
        return
    try:
        os.makedirs(logdir, exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
    except Exception as e:          # observability never fails the run
        warnings.warn(f"profiler capture did not start: {e!r}",
                      RuntimeWarning)
        prof = None
    if prof is None:
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(logdir, f"trace_{time.time_ns()}.json"))
        except Exception as e:      # observability never fails the run
            warnings.warn(f"profiler capture did not finish: {e!r}",
                          RuntimeWarning)


def _synchronize(out) -> None:
    """Wait for the card if any tensor in ``out`` lies on one."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _synchronize(v)


def capture_step(fn: Callable, args: Sequence, logdir: Optional[str],
                 reps: int = 1) -> Optional[str]:
    """Run ``fn(*args)`` once outside the window (kernels build, caches
    warm), then ``reps`` times inside a capture window, synchronising on
    the output before the window closes so the trace holds the device
    work.  Returns ``logdir`` when a trace was recorded, None when capture
    was skipped."""
    _synchronize(fn(*args))
    with capture(logdir) as recording:
        for _ in range(max(int(reps), 1)):
            out = fn(*args)
        _synchronize(out)
    return logdir if recording else None

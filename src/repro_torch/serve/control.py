"""Closed-loop serving control: hill-climbing the scheduler's knobs online.

The fleet side already owns a windowed hill-climb phase machine
(``repro_torch.fleet.control.ClimbCore``, extracted from the training-side
``HillClimbController``): probe a neighbour, bracket ambiguous probes with a
confirm window to cancel drift, accept with doubling steps, revert with a
direction flip.  :class:`ServeController` reuses it verbatim for serving —
one core per scheduler knob, rotated round-robin (coordinate descent):

* ``chunk_tokens`` over an ordered grid ending at ``None`` (whole-prompt).
  The relaxed end is ``None``: fewer per-chunk launches, so ties prefer it.
* ``priority`` over :data:`~repro_torch.serve.scheduler.PRIORITIES` — a
  two-point axis whose relaxed end is ``decode_first`` (protects in-flight
  work).
* ``active_runners`` in ``[1, n_runners]`` — the relaxed end is *fewer*
  replicas, so on a goodput plateau the controller scales the deployment
  down rather than holding idle replicas (ties prefer the relaxed end).

The objective is the rolling **deadline-met goodput** the scheduler already
maintains (``sched.window.goodput(now)``) — the serving twin of the fleet
controller's loss-progress-per-second.  One axis is live at a time; every
core still sees every objective sample via ``note_scale`` so noise floors
stay calibrated.  For clean credit assignment run the scheduler with
``control_every_s >= window_s`` so consecutive windows don't overlap.

Carried over from ``repro/serve/control.py`` with its logic unchanged: on
equal traces and cost models both packages take the same actions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.fleet.control import _SETTLE, ClimbCore
from repro_torch.serve.scheduler import PRIORITIES, Scheduler

# chunk grid: ascending cost-granularity, whole-prompt (None) last so the
# relaxed direction (+1) points at fewer, larger chunks
DEFAULT_CHUNK_GRID: Tuple[Optional[int], ...] = (16, 32, 64, 128, None)


@dataclasses.dataclass(frozen=True)
class ServeAction:
    """One controller decision: which knob moved, to what, and why."""
    t: float
    axis: str
    value: object
    reason: str


class _Axis:
    """One knob: a ClimbCore over integer indices plus its apply mapping."""

    def __init__(self, name: str, core: ClimbCore,
                 apply: Callable[[Scheduler, int], None],
                 value_of: Callable[[int], object]):
        self.name = name
        self.core = core
        self.apply = apply
        self.value_of = value_of


class ServeController:
    """Coordinate-descent hill climb over the Scheduler's three knobs.

    Drive it via ``Scheduler.run(..., controller=ctrl)``; the scheduler
    calls :meth:`tick` every ``control_every_s`` sim seconds.  Axes bind
    lazily on the first tick (they need the scheduler's ``n_runners`` and
    current knob values as starting points), so one controller instance
    serves exactly one run.
    """

    def __init__(self, chunk_grid: Sequence[Optional[int]] = DEFAULT_CHUNK_GRID,
                 tol: float = 0.1, probe_every: int = 2, warm_ticks: int = 1):
        if not chunk_grid:
            raise ValueError("chunk_grid must be non-empty")
        self.chunk_grid = tuple(chunk_grid)
        self.tol = float(tol)
        self.probe_every = max(int(probe_every), 1)
        self.actions: List[ServeAction] = []
        self._warm = max(int(warm_ticks), 0)
        self._axes: Optional[List[_Axis]] = None
        self._i = 0

    # -- binding ------------------------------------------------------------

    def _bind(self, sched: Scheduler) -> None:
        grid = self.chunk_grid
        try:
            chunk_start = grid.index(sched.chunk_tokens)
        except ValueError:
            # scheduler starts off-grid: snap to the relaxed end and make
            # the core's belief match the running config
            chunk_start = len(grid) - 1
            sched.set_chunk_tokens(grid[chunk_start])
        axes = [
            _Axis("chunk_tokens",
                  ClimbCore(0, len(grid) - 1, chunk_start, tol=self.tol,
                            probe_every=self.probe_every, relax_dir=1),
                  lambda s, i: s.set_chunk_tokens(grid[i]),
                  lambda i: grid[i]),
            _Axis("priority",
                  ClimbCore(0, len(PRIORITIES) - 1,
                            PRIORITIES.index(sched.priority), tol=self.tol,
                            probe_every=self.probe_every, relax_dir=-1),
                  lambda s, i: s.set_priority(PRIORITIES[i]),
                  lambda i: PRIORITIES[i]),
            _Axis("active_runners",
                  ClimbCore(1, sched.n_runners, sched.active_runners,
                            tol=self.tol, probe_every=self.probe_every,
                            relax_dir=-1),
                  lambda s, i: s.set_active_runners(i),
                  lambda i: i),
        ]
        self._axes = axes

    # -- control loop -------------------------------------------------------

    def tick(self, now: float, sched: Scheduler) -> Optional[ServeAction]:
        if self._axes is None:
            self._bind(sched)
        obj = sched.window.goodput(now)
        for ax in self._axes:
            ax.core.note_scale(obj)     # every axis tracks the noise floor
        if self._warm > 0:              # first window is ramp-transient
            self._warm -= 1
            return None
        ax = self._axes[self._i]
        move = ax.core.observe(obj)
        act = None
        if move is not None:
            idx, reason = move
            ax.apply(sched, idx)
            act = ServeAction(now, ax.name, ax.value_of(idx), reason)
            self.actions.append(act)
        if ax.core.phase == _SETTLE:
            # the axis finished a probe cycle (or is just holding its
            # reference): hand the next window to the next knob
            self._i = (self._i + 1) % len(self._axes)
        return act

"""Multi-runner scheduler: one event loop, N runner lanes, chunked prefill.

Carried over from ``repro/serve/scheduler.py`` with its logic unchanged, so
equal traces and cost models give identical schedules and summaries in both
packages; a lane's :class:`SlotRunner` is the port's, so a real lane runs
the Hopper kernels.

:class:`Scheduler` generalises :class:`~repro_torch.serve.engine.ContinuousBatchingServer`
along three axes:

* **N runner lanes** — admissions fan out across ``n_runners`` lanes
  (least-loaded assignment), each with its own queue, slots, and optional
  :class:`~repro_torch.serve.engine.SlotRunner`.  Lanes progress *concurrently in
  sim time*: every lane action (a decode step, a prefill chunk) is a
  RUNNER_FREE event on the one shared :class:`~repro_torch.sim.EventQueue` with
  the lane index as actor id, so a 4-lane run is a true parallel-server
  simulation on one clock, not four serialised single-server runs.
* **Chunked-interleaved prefill** — a prompt is prefilled in
  ``chunk_tokens``-sized pieces (``StepCostModel.prefill_chunk_s`` each)
  instead of one blocking call, and in-flight prefill jobs are served
  *round-robin*, so a short prompt overtakes a long prompt mid-prefill
  instead of queueing behind its full cost.  ``chunk_tokens=None`` recovers
  the whole-prompt discipline.  The ``priority`` knob arbitrates between
  pending decode and pending prefill work: ``prefill_first`` drains prefill
  chunks before decoding (TTFT-greedy), ``decode_first`` strictly
  alternates when both are pending (TPOT-protective).
* **Online knobs** — ``chunk_tokens`` / ``priority`` / ``active_runners``
  are mutable mid-run; a controller hook fires every ``control_every_s``
  sim seconds with the rolling deadline-met goodput window
  (:class:`~repro_torch.serve.control.ServeController` closes the loop).

Every admitted request reaches exactly one terminal state — finish, evict
(deadline fired mid-flight or mid-prefill), or drop (expired in queue) —
audited at end of run (``summary["conservation_ok"]``).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.obs.callbacks import serve_event
from repro_torch.serve.engine import (DEADLINE, REQUEST_ARRIVAL, SlotRunner,
                                      StepCostModel, _ServerBase)
from repro_torch.serve.metrics import RollingWindow, summarize
from repro_torch.serve.requests import Request

RUNNER_FREE = "runner_free"

PRIORITY_DECODE_FIRST = "decode_first"
PRIORITY_PREFILL_FIRST = "prefill_first"
PRIORITIES = (PRIORITY_DECODE_FIRST, PRIORITY_PREFILL_FIRST)


class _PrefillJob:
    """One request's in-flight chunked prefill (slot already reserved)."""

    __slots__ = ("req", "slot", "done", "handle")

    def __init__(self, req: Request, slot: int, handle=None):
        self.req = req
        self.slot = slot
        # prompt tokens prefilled so far — a prefix-sharing runner hands out
        # jobs already advanced past the matched span (done_tokens > 0), so
        # the sim charges chunk time only for the tokens actually computed
        self.done = getattr(handle, "done_tokens", 0)
        self.handle = handle        # SlotRunner ChunkedPrefill job, if real

    @property
    def remaining(self) -> int:
        return self.req.prompt_len - self.done


class _Lane:
    """Per-runner scheduling state: queue, slots, in-flight prefill jobs."""

    def __init__(self, idx: int, max_batch: int,
                 runner: Optional[SlotRunner]):
        self.idx = idx
        self.runner = runner
        self.queue: Deque[Request] = deque()
        self.jobs: Deque[_PrefillJob] = deque()     # round-robin service
        self.active: Dict[int, Request] = {}        # slot -> request
        self.free = list(range(max_batch))[::-1]    # pop() yields slot 0
        self.busy = False           # has a RUNNER_FREE event in flight
        self.last_decode = False    # decode_first alternation state

    @property
    def load(self) -> int:
        return len(self.queue) + len(self.jobs) + len(self.active)


class Scheduler(_ServerBase):
    """Admission fan-out over N runner lanes with interleavable prefill."""

    def __init__(self, max_batch: int, cost: StepCostModel,
                 n_runners: int = 1,
                 runners: Optional[List[SlotRunner]] = None,
                 tracker=None,
                 chunk_tokens: Optional[int] = None,
                 priority: str = PRIORITY_DECODE_FIRST):
        if runners is not None and len(runners) != n_runners:
            raise ValueError(f"{len(runners)} runners for {n_runners} lanes")
        # _ServerBase validates the (single) runner/slot-count pairing; the
        # lanes each hold their own runner, so the base sees only the first
        super().__init__(max_batch, cost,
                         runner=runners[0] if runners else None,
                         tracker=tracker)
        if runners is not None:
            for r in runners:
                if r.max_batch != max_batch:
                    raise ValueError(f"runner has {r.max_batch} slots, "
                                     f"scheduler wants {max_batch}")
        self.n_runners = n_runners
        self.lanes = [_Lane(i, max_batch,
                            runners[i] if runners else None)
                      for i in range(n_runners)]
        self._chunk_tokens: Optional[int] = None
        self._priority = PRIORITY_DECODE_FIRST
        self._active_runners = n_runners
        self.set_chunk_tokens(chunk_tokens)
        self.set_priority(priority)
        self.window: Optional[RollingWindow] = None
        self._terminal: Dict[int, int] = {}

    # -- knobs (mutable mid-run; the ServeController drives these) ---------

    @property
    def chunk_tokens(self) -> Optional[int]:
        return self._chunk_tokens

    def set_chunk_tokens(self, v: Optional[int]) -> None:
        if v is not None and v < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {v}")
        self._chunk_tokens = None if v is None else int(v)

    @property
    def priority(self) -> str:
        return self._priority

    def set_priority(self, v: str) -> None:
        if v not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}")
        self._priority = v

    @property
    def active_runners(self) -> int:
        return self._active_runners

    def set_active_runners(self, v: int) -> None:
        if not 1 <= v <= self.n_runners:
            raise ValueError(
                f"active_runners must be in [1, {self.n_runners}], got {v}")
        old = self._active_runners
        self._active_runners = int(v)
        if v < old:
            # deactivated lanes drain their in-flight work but hand their
            # *unstarted* queue back to the live lanes
            for lane in self.lanes[v:old]:
                moved, lane.queue = lane.queue, deque()
                for r in moved:
                    self._enqueue(r)

    # -- event loop ---------------------------------------------------------

    def run(self, requests: List[Request],
            horizon_s: Optional[float] = None,
            controller=None, control_every_s: float = 1.0,
            window_s: float = 2.0):
        clock, q, recs, reqs = self._prime(requests)
        self._q, self._recs, self._clock = q, recs, clock
        self.window = RollingWindow(window_s)
        self._terminal = {}
        next_ctl = control_every_s
        while q:
            e = q.pop()
            clock.advance_to(max(e.time, clock.now))
            while controller is not None and clock.now >= next_ctl:
                controller.tick(next_ctl, self)
                next_ctl += control_every_s
            if e.kind == REQUEST_ARRIVAL:
                self._enqueue(reqs[e.actor])
            elif e.kind == DEADLINE:
                self._evict_rid(e.actor)
            elif e.kind == RUNNER_FREE:
                self._lane_work(self.lanes[e.actor])
        horizon = max(clock.now, horizon_s or 0.0)
        summary = summarize(list(recs.values()), horizon)
        summary["conservation_ok"] = self._conservation_ok(recs)
        summary["chunk_tokens"] = self._chunk_tokens
        summary["priority"] = self._priority
        summary["active_runners"] = self._active_runners
        share = self._share_stats()
        if share is not None:
            summary["prefix_sharing"] = share
        self._log_summary(summary)
        return list(recs.values()), summary

    def _share_stats(self):
        """Fold per-lane prefix-sharing counters into one scorecard (None
        when no lane runs a sharing-enabled runner — legacy summaries are
        unchanged)."""
        per_lane = [s for s in
                    (lane.runner.share_stats() for lane in self.lanes
                     if lane.runner is not None
                     and hasattr(lane.runner, "share_stats"))
                    if s is not None]
        if not per_lane:
            return None
        agg = {k: sum(s[k] for s in per_lane) for k in per_lane[0]}
        agg["prefix_hit_rate"] = (agg["hits"] / agg["lookups"]
                                  if agg["lookups"] else 0.0)
        agg["pages_saved_frac"] = (agg["pages_saved"] / agg["pages_asked"]
                                   if agg["pages_asked"] else 0.0)
        return agg

    def _conservation_ok(self, recs) -> bool:
        """Every request reached exactly one terminal state."""
        for rid, rec in recs.items():
            terminal = self._terminal.get(rid, 0)
            if terminal != 1:
                return False
            if (rec.finish_s is not None) == (rec.dropped is not None):
                return False        # exactly one of finished / dropped
        return True

    def _mark_terminal(self, rid: int, t: float) -> None:
        self._terminal[rid] = self._terminal.get(rid, 0) + 1
        rec = self._recs[rid]
        self.window.record(t, rec.tokens_out if rec.met_deadline else 0)

    # -- admissions ---------------------------------------------------------

    def _enqueue(self, r: Request) -> None:
        lane = min(self.lanes[:self._active_runners], key=lambda l: l.load)
        lane.queue.append(r)
        self._wake(lane)

    def _wake(self, lane: _Lane) -> None:
        if not lane.busy:
            lane.busy = True
            self._q.push(self._clock.now, RUNNER_FREE, lane.idx)

    def _prefill_eta_s(self, lane: _Lane, r: Request) -> float:
        """Predicted wall time for ``r``'s prefill under the *current*
        discipline: whole-prompt is just ``prefill_s``; chunked adds the
        round-robin share of every in-flight job's remaining chunks, plus
        one decode step per own chunk under decode_first alternation.  A
        sharper shed rule than the uninterrupted-prefill bound — admitting
        a prompt whose interleaved TTFT is already doomed only burns chunk
        time until its deadline eviction."""
        c = self._chunk_tokens
        if c is None:
            return self.cost.prefill_s(r.prompt_len)
        own = -(-r.prompt_len // c)
        eta = (own * self.cost.prefill_base_s
               + self.cost.prefill_token_s * r.prompt_len)
        for job in lane.jobs:       # chunks served ahead of ours, round-robin
            share = min(own, -(-job.remaining // c))
            eta += (share * self.cost.prefill_base_s
                    + self.cost.prefill_token_s * min(job.remaining,
                                                      share * c))
        if self._priority == PRIORITY_DECODE_FIRST and lane.active:
            eta += own * self.cost.decode_step_s
        return eta

    def _admit_from_queue(self, lane: _Lane, now: float) -> None:
        """Turn queued requests into prefill jobs while slots (and pages,
        for a paged runner) are available; shed requests whose predicted
        interleaved prefill can no longer meet their TTFT budget."""
        while lane.free and lane.queue:
            r = lane.queue[0]
            if (now + self._prefill_eta_s(lane, r)
                    > r.arrival_s + r.slo_ttft_s
                    or now > r.deadline_s):
                lane.queue.popleft()
                rec = self._recs[r.rid]
                rec.dropped = "expired_in_queue"
                self._mark_terminal(r.rid, now)
                if self.tracker.active:
                    serve_event(self.tracker, "drop", rid=r.rid, t=now,
                                reason="expired_in_queue", runner=lane.idx)
                continue
            if lane.runner is not None and not lane.runner.can_admit(r):
                if not lane.jobs and not lane.active:
                    # nothing in flight will ever free pages: the request
                    # outsizes the pool itself — shed it or the lane idles
                    # forever with a queued request (conservation violation)
                    lane.queue.popleft()
                    rec = self._recs[r.rid]
                    rec.dropped = "insufficient_pages"
                    self._mark_terminal(r.rid, now)
                    if self.tracker.active:
                        serve_event(self.tracker, "drop", rid=r.rid, t=now,
                                    reason="insufficient_pages",
                                    runner=lane.idx)
                    continue
                break               # in-flight work will free pages; wait
            lane.queue.popleft()
            slot = lane.free.pop()
            self._recs[r.rid].admit_s = now
            handle = (lane.runner.start_prefill(r)
                      if lane.runner is not None else None)
            lane.jobs.append(_PrefillJob(r, slot, handle))
            # arm the deadline now: a request stuck mid-prefill past its
            # deadline is evicted, not ground out for zero goodput
            self._q.push(r.deadline_s, DEADLINE, r.rid)

    # -- lane actions -------------------------------------------------------

    def _lane_work(self, lane: _Lane) -> None:
        now = self._clock.now
        self._admit_from_queue(lane, now)
        do_prefill = bool(lane.jobs) and (
            self._priority == PRIORITY_PREFILL_FIRST
            or not lane.active or lane.last_decode)
        if do_prefill:
            t_end = self._prefill_chunk(lane, now)
            lane.last_decode = False
        elif lane.active:
            t_end = self._decode_step(lane, now)
            lane.last_decode = True
        else:
            lane.busy = False       # idle until the next assignment
            return
        lane.busy = True
        self._q.push(t_end, RUNNER_FREE, lane.idx)

    def _prefill_chunk(self, lane: _Lane, now: float) -> float:
        """Serve one chunk of the lane's oldest pending prefill job;
        unfinished jobs rotate to the tail (round-robin), so no prompt
        monopolises the lane."""
        job = lane.jobs.popleft()
        n = (job.remaining if self._chunk_tokens is None
             else min(self._chunk_tokens, job.remaining))
        t_end = now + self.cost.prefill_chunk_s(n)
        job.done += n
        if job.handle is not None:
            job.handle.step(n)
        if job.remaining > 0:
            lane.jobs.append(job)
            return t_end
        # final chunk: land the request — insert + first token
        r, rec = job.req, self._recs[job.req.rid]
        if lane.runner is not None:
            lane.runner.finish_prefill(job.slot, r, job.handle)
        rec.first_token_s = t_end
        rec.tokens_out = 1
        if self.tracker.active:
            serve_event(self.tracker, "admit", rid=r.rid, t=rec.admit_s,
                        slot=job.slot, runner=lane.idx,
                        ttft_s=rec.first_token_s - rec.arrival_s)
        if r.max_new_tokens <= 1:
            self._finish(lane, job.slot, r, t_end)
        else:
            lane.active[job.slot] = r
        return t_end

    def _decode_step(self, lane: _Lane, now: float) -> float:
        t_end = now + self.cost.decode_step_s
        if lane.runner is not None:
            lane.runner.step(sorted(lane.active))
        for slot in sorted(lane.active):
            rec = self._recs[lane.active[slot].rid]
            rec.tokens_out += 1
            if rec.tokens_out >= rec.target_tokens:
                self._finish(lane, slot, lane.active[slot], t_end)
        return t_end

    # -- terminal transitions ----------------------------------------------

    def _finish(self, lane: _Lane, slot: int, r: Request, t: float) -> None:
        lane.active.pop(slot, None)
        lane.free.append(slot)
        rec = self._recs[r.rid]
        rec.finish_s = t
        if lane.runner is not None:
            lane.runner.release(slot)
        self._mark_terminal(r.rid, t)
        if self.tracker.active:
            serve_event(self.tracker, "finish", rid=r.rid, t=t, slot=slot,
                        runner=lane.idx, tokens_out=rec.tokens_out)

    def _evict_rid(self, rid: int) -> None:
        rec = self._recs[rid]
        if rec.finish_s is not None or rec.dropped is not None:
            return                  # already terminal
        now = self._clock.now
        for lane in self.lanes:
            for slot, r in list(lane.active.items()):
                if r.rid == rid:
                    lane.active.pop(slot)
                    lane.free.append(slot)
                    rec.dropped = "slo_miss"
                    if lane.runner is not None:
                        lane.runner.release(slot)
                    self._mark_terminal(rid, now)
                    if self.tracker.active:
                        serve_event(self.tracker, "evict", rid=rid, t=now,
                                    slot=slot, runner=lane.idx,
                                    reason="slo_miss",
                                    tokens_out=rec.tokens_out)
                    return
            for job in list(lane.jobs):
                if job.req.rid == rid:
                    lane.jobs.remove(job)
                    lane.free.append(job.slot)
                    if lane.runner is not None:
                        # unwind the admission-time page reservation and any
                        # shared-page refs this job holds
                        lane.runner.cancel_prefill(job.handle)
                    rec.dropped = "slo_miss"
                    self._mark_terminal(rid, now)
                    if self.tracker.active:
                        serve_event(self.tracker, "evict", rid=rid, t=now,
                                    slot=job.slot, runner=lane.idx,
                                    reason="slo_miss_prefill",
                                    tokens_out=0)
                    return

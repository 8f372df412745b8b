"""Batching schedulers on the discrete-event core, and the real slot runner.

Counterpart of ``repro/serve/engine.py``.  Two disciplines over the same
slot-cache decode path:

* :class:`ContinuousBatchingServer` — admit-on-free-slot: a request is
  prefilled into any free slot the moment one exists, so requests of mixed
  age decode together in one step.  A running request whose deadline fires
  is *evicted* (drop-on-SLO-miss), freeing its slot.
* :class:`StaticBatchingServer` — wait until ``batch`` requests are queued
  (or arrivals are exhausted), prefill them all, decode until the *last*
  one finishes, release everything, repeat.

Time is simulated on :class:`~repro_torch.sim.SimClock` and
:class:`~repro_torch.sim.EventQueue`, with step costs from a
:class:`StepCostModel` (timed on the card by :func:`measured_cost_model`,
or synthetic for deterministic runs).  The scheduling logic is the
reference's, unchanged, so equal traces and cost models give identical
schedules and summaries in both packages.

Execution is optional: attach a :class:`SlotRunner` and the scheduler
really decodes (fixed-slot or paged caches, chunked prefill on
``flash_attention``, decode on ``flash_decode`` / ``flash_decode_paged``,
greedy or temperature sampling) while the clock runs on the cost model.
:class:`PrefixSimRunner` carries the page allocator and prefix index into
the pure-sim runs without executing anything.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.decode import (ChunkedPrefill, decode_step,
                                       gather_prefix_kv, init_cache,
                                       init_paged_cache, init_slot_cache,
                                       pages_needed, paged_evict,
                                       prefill_cache, prefix_sharing_supported,
                                       slot_insert)
from repro_torch.models.paging import PagePool, PrefixIndex
from repro_torch.obs import spans
from repro_torch.obs.callbacks import SERVE_SUMMARY, serve_event
from repro_torch.obs.tracker import NOOP
from repro_torch.serve.metrics import RequestRecord, summarize
from repro_torch.serve.requests import Request
from repro_torch.sim import EventQueue, SimClock

REQUEST_ARRIVAL = "request_arrival"
DEADLINE = "deadline"

# the template arm of the prompt seeds: far above any request id
TEMPLATE_ARM = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Sim-seconds charged per scheduler action (single-accelerator model)."""
    decode_step_s: float              # one decode step, whole batch
    prefill_token_s: float            # fused prefill, per prompt token
    prefill_base_s: float = 0.0       # dispatch overhead per prefill call

    def prefill_s(self, prompt_len: int) -> float:
        return self.prefill_base_s + self.prefill_token_s * prompt_len

    def prefill_chunk_s(self, n_tokens: int) -> float:
        """One interleaved prefill chunk: every chunk pays the dispatch base
        again — the cost side of the scheduler's ``chunk_tokens`` knob."""
        return self.prefill_base_s + self.prefill_token_s * n_tokens


def _timed(fn, device: torch.device, reps: int) -> float:
    """Seconds per call of ``fn`` after one warm-up call: CUDA events around
    ``reps`` back-to-back calls on the card (the host issues while the card
    runs, so this is the larger of the two), the host clock elsewhere."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measured_cost_model(params, cfg, ctx, max_batch: int, cache_len: int,
                        prompt_len: int, reps: int = 3,
                        pattern=None) -> StepCostModel:
    """Time the real decode step and fused prefill on ``ctx.device``.

    Prefill is timed at two prompt lengths and fit as base + per-token, so a
    call's dispatch overhead is not charged per token (it would overcharge
    the short chunks of the chunked scheduler).  Each timed call starts from
    the same cache state: the caches are written in place, so ``pos`` is
    put back before every call.
    """
    dev = resolve_device(ctx.device)
    cache = init_slot_cache(cfg, max_batch, cache_len, ctx, pattern=pattern)
    pos0 = cache["pos"]
    toks = torch.zeros((max_batch, 1), dtype=torch.long, device=dev)

    def step():
        cache["pos"] = pos0
        decode_step(params, cache, toks, cfg, ctx, pattern=pattern)

    def prefill_time(n: int) -> float:
        one = init_cache(cfg, 1, cache_len, ctx, pattern=pattern)
        one["pos"] = torch.zeros((1,), dtype=torch.int32, device=dev)
        start = one["pos"]
        prompt = torch.zeros((1, n), dtype=torch.long, device=dev)

        def call():
            one["pos"] = start
            prefill_cache(params, prompt, one, cfg, ctx, pattern=pattern)
        return _timed(call, dev, reps)

    t_step = _timed(step, dev, reps)
    l1 = max(1, prompt_len // 2)
    t2 = prefill_time(prompt_len)
    if l1 == prompt_len:
        return StepCostModel(decode_step_s=t_step,
                             prefill_token_s=t2 / prompt_len)
    t1 = prefill_time(l1)
    tok = (t2 - t1) / (prompt_len - l1)
    if tok <= 0:            # timing noise swamped the slope; fall back
        return StepCostModel(decode_step_s=t_step,
                             prefill_token_s=t2 / prompt_len)
    base = max(0.0, t1 - tok * l1)
    return StepCostModel(decode_step_s=t_step, prefill_token_s=tok,
                         prefill_base_s=base)


class SlotRunner:
    """Real slot-cache execution behind a scheduler (optional).

    Owns the ``max_batch``-slot cache (fixed-slot, or paged with
    ``page_size``/``num_pages``), per-slot next-token state and the sampling
    chain.  Prompt tokens come from numpy, one stream per request id
    (``default_rng([seed, rid])``); a request carrying a ``template`` draws
    its first ``prefix_len`` tokens from the template's stream
    (``default_rng([seed, 0xFFFFFFFF, template])``) instead, so same-template
    requests share a real token prefix.  The reference draws with
    ``jax.random``, so parity runs inject the same prompts into both.

    Paged admission protocol: ``can_admit`` *reserves* the request's
    new-page budget (and keeps the prefix-match plan), ``start_prefill``
    hands out the seeded :class:`ChunkedPrefill` job, ``finish_prefill``
    allocates against the reservation and inserts, ``cancel_prefill``
    unwinds a job evicted mid-prefill.  ``prefix_sharing=True`` (paged, and
    where ``prefix_sharing_supported``) adds the prefix cache: finished
    prompts donate their full pages to a :class:`PrefixIndex`, admissions
    longest-prefix-match against it, matched pages are shared through the
    block table and the matched span skips prefill.
    """

    def __init__(self, params, cfg, ctx, max_batch: int, cache_len: int,
                 pattern=None, temperature: float = 0.0, seed: int = 0,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_sharing: bool = False):
        self.cfg, self.ctx = cfg, ctx
        self.device = resolve_device(ctx.device)
        self.params = params
        self.max_batch, self.cache_len = max_batch, cache_len
        self.temperature = temperature
        self.seed = int(seed)
        self._pattern = pattern
        self.page_size = page_size
        self.prefix_index: Optional[PrefixIndex] = None
        if page_size is not None:
            if num_pages is None:
                raise ValueError("paged runner needs num_pages")
            self.cache = init_paged_cache(cfg, max_batch, cache_len, ctx,
                                          page_size=page_size,
                                          num_pages=num_pages,
                                          pattern=pattern)
            self.pool: Optional[PagePool] = PagePool(num_pages)
            if prefix_sharing:
                pg = prefix_sharing_supported(cfg, cache_len, page_size,
                                              pattern)
                if pg is not None:
                    self.prefix_index = PrefixIndex(pg)
        else:
            self.cache = init_slot_cache(cfg, max_batch, cache_len, ctx,
                                         pattern=pattern)
            self.pool = None
        self._slot_pages: Dict[int, List[int]] = {}
        self._plans: Dict[int, Dict[str, Any]] = {}      # rid -> admit plan
        self._inflight: Dict[int, Dict[str, Any]] = {}   # id(job) -> plan
        self.prefill_tokens_skipped = 0
        self.pages_asked = 0        # sum of pages over admissions
        self.pages_alloc = 0        # newly allocated (non-shared) pages
        # sampling has its own stream, never shared with the prompts'
        sample_seed = int(np.random.SeedSequence([self.seed, 1])
                          .generate_state(1)[0])
        self._gen = torch.Generator(device=self.device).manual_seed(
            sample_seed)
        self.next_tok = torch.zeros((max_batch,), dtype=torch.long,
                                    device=self.device)
        self.generated: Dict[int, List[int]] = {}
        self._slot_rid: List[Optional[int]] = [None] * max_batch

    def prompt_tokens(self, req: Request) -> torch.Tensor:
        """(1, prompt_len) int64 host tensor of ``req``'s prompt."""
        vocab = self.cfg.vocab_size
        own = np.random.default_rng([self.seed, req.rid])
        if req.template is not None and req.prefix_len > 0:
            npre = min(req.prefix_len, req.prompt_len - 1)
            tpl = np.random.default_rng([self.seed, TEMPLATE_ARM,
                                         req.template])
            toks = np.concatenate([
                tpl.integers(0, vocab, npre),
                own.integers(0, vocab, req.prompt_len - npre)])
        else:
            toks = own.integers(0, vocab, req.prompt_len)
        return torch.from_numpy(toks.astype(np.int64))[None]

    def _init_one(self):
        c = init_cache(self.cfg, 1, self.cache_len, self.ctx,
                       pattern=self._pattern)
        c["pos"] = torch.zeros((1,), dtype=torch.int32, device=self.device)
        return c

    def _sample(self, logits):
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def pages_for(self, req: Request) -> int:
        """Pages ``req`` needs for its full lifetime (0 in fixed-slot mode)."""
        if self.pool is None:
            return 0
        return pages_needed(self.cfg, self.cache_len, self.page_size,
                            req.prompt_len + req.max_new_tokens,
                            self._pattern)

    # -- admission plan: match + reserve at can_admit, consume at prefill ----

    def _make_plan(self, req: Request) -> Optional[Dict[str, Any]]:
        """Match the prompt against the prefix index and reserve the *new*
        pages.  Shared full pages are increfed here, so they cannot be
        reclaimed under the admission.  Returns None (no side effects
        survive) when the pool cannot cover the new pages even after
        reclaiming index-only pages."""
        total = self.pages_for(req)
        tokens = self.prompt_tokens(req)
        plan: Dict[str, Any] = {"req": req, "tokens": tokens, "host": None,
                                "shared": [], "matched": 0, "tail_page": None,
                                "new": total, "total": total}
        if self.prefix_index is not None:
            # Python ints: a tensor element hashes by identity
            host = tuple(int(t) for t in tokens[0].tolist())
            m = self.prefix_index.match(host, limit=req.prompt_len - 1)
            if m.pages:
                self.pool.incref(m.pages)
            plan.update(host=host, shared=list(m.pages), matched=m.tokens,
                        tail_page=m.tail_page, new=total - m.n_pages)
        short = plan["new"] - self.pool.available
        if short > 0 and self.prefix_index is not None:
            self.prefix_index.reclaim(short, self.pool)
        if not self.pool.reserve(plan["new"]):
            if plan["shared"]:
                self.pool.free(plan["shared"])
            return None
        return plan

    def _release_plan(self, plan: Dict[str, Any]) -> None:
        self.pool.unreserve(plan["new"])
        if plan["shared"]:
            for p in self.pool.free(plan["shared"]):
                self.prefix_index.invalidate_tail(p)

    def can_admit(self, req: Request) -> bool:
        """Reserve ``req``'s new-page budget (True) or report page pressure
        (False).  A True here must be followed by ``start_prefill``: the
        reservation and any shared-page refs are parked in the plan."""
        if self.pool is None:
            return True
        stale = self._plans.pop(req.rid, None)
        if stale is not None:       # re-check after a failed earlier pass
            self._release_plan(stale)
        plan = self._make_plan(req)
        if plan is None:
            return False
        self._plans[req.rid] = plan
        return True

    def admit(self, slot: int, req: Request) -> None:
        """Fused prefill + slot insert; samples the request's first token.
        The whole-prompt path (ContinuousBatchingServer): no reservation, no
        prefix sharing; pages are allocated inline and exhaustion raises."""
        logits, src = prefill_cache(
            self.params, self.prompt_tokens(req).to(self.device),
            self._init_one(), self.cfg, self.ctx, pattern=self._pattern)
        self._insert_slot(slot, req, logits, src)

    def start_prefill(self, req: Request) -> ChunkedPrefill:
        """A :class:`ChunkedPrefill` job for ``req``, which the scheduler
        advances with ``job.step(n)`` and lands with :meth:`finish_prefill`.
        With a prefix hit the job starts at the first uncached token: the
        matched span's K/V is gathered off the shared pages into its carry
        (the gather of a partial tail page is the copy-on-write copy)."""
        plan = self._plans.pop(req.rid, None)
        if plan is None and self.pool is not None:
            plan = self._make_plan(req)
            if plan is None:
                raise RuntimeError(
                    f"page pool exhausted admitting rid={req.rid} "
                    f"(available={self.pool.available})")
        tokens = (plan["tokens"] if plan is not None
                  else self.prompt_tokens(req))
        matched = plan["matched"] if plan is not None else 0
        prefix_kv = None
        if matched:
            rows = list(plan["shared"])
            if plan["tail_page"] is not None:
                rows.append(plan["tail_page"])
            prefix_kv = gather_prefix_kv(self.cache, rows, matched)
            self.prefill_tokens_skipped += matched
        job = ChunkedPrefill(self.params, tokens.to(self.device),
                             self._init_one(), self.cfg, self.ctx,
                             pattern=self._pattern, start_token=matched,
                             prefix_kv=prefix_kv)
        if plan is not None:
            self._inflight[id(job)] = plan
        return job

    def finish_prefill(self, slot: int, req: Request, job) -> None:
        """Insert a completed ChunkedPrefill job into ``slot``."""
        logits, src = job.finish()
        self._insert_slot(slot, req, logits, src,
                          plan=self._inflight.pop(id(job), None))

    def cancel_prefill(self, job) -> None:
        """Unwind a job evicted mid-prefill: return its page reservation and
        drop its shared-page refs (never freeing a page another slot or the
        index still holds)."""
        plan = self._inflight.pop(id(job), None)
        if plan is not None:
            self._release_plan(plan)

    def _insert_slot(self, slot: int, req: Request, logits, src,
                     plan: Optional[Dict[str, Any]] = None) -> None:
        if self.pool is not None:
            if plan is not None:
                new = self.pool.alloc(plan["new"], reserved=True)
            else:               # admit() path: inline allocation
                new = self.pool.alloc(self.pages_for(req))
            if new is None:
                raise RuntimeError(
                    f"page pool exhausted admitting rid={req.rid} "
                    f"(available={self.pool.available})")
            shared = plan["shared"] if plan is not None else []
            pages = shared + new
            self._slot_pages[slot] = pages
            slot_insert(self.cache, slot, src, pages=pages,
                        skip_cols=len(shared))
            self.pages_asked += len(pages)
            self.pages_alloc += len(new)
            if self.prefix_index is not None and plan is not None:
                # donate: register this prompt's full pages (the index
                # increfs the new ones) and its partial tail as a CoW source
                self.prefix_index.insert(plan["host"], pages, self.pool)
        else:
            slot_insert(self.cache, slot, src)
        first = self._sample(logits)[0]
        self.next_tok[slot] = first
        self.generated[req.rid] = [int(first)]
        self._slot_rid[slot] = req.rid

    def step(self, active_slots: List[int]) -> None:
        """One decode step over the whole slot batch; records new tokens for
        the active slots only (free slots ride along, output ignored)."""
        with spans.span("repro.serve.decode"):
            logits, self.cache = decode_step(self.params, self.cache,
                                             self.next_tok[:, None], self.cfg,
                                             self.ctx, pattern=self._pattern)
        with spans.span("repro.serve.sample"):
            self.next_tok = self._sample(logits)
            nxt = self.next_tok.tolist()
        for s in active_slots:
            rid = self._slot_rid[s]
            if rid is not None:
                self.generated[rid].append(nxt[s])

    def release(self, slot: int) -> None:
        self._slot_rid[slot] = None
        if self.pool is not None:
            # retarget the slot's table at its scratch row *before* returning
            # pages: the freed slot keeps riding the batch and must not write
            # into pages another request may get next
            paged_evict(self.cache, slot)
            released = self.pool.free(self._slot_pages.pop(slot))
            if self.prefix_index is not None:
                # recycled pages can no longer back a CoW tail lookup
                for p in released:
                    self.prefix_index.invalidate_tail(p)

    def share_stats(self) -> Optional[Dict[str, Any]]:
        """Prefix-sharing counters for the run summary (None if sharing is
        off)."""
        if self.prefix_index is None:
            return None
        st = self.prefix_index.stats()
        st["prefill_tokens_skipped"] = self.prefill_tokens_skipped
        st["pages_asked"] = self.pages_asked
        st["pages_alloc"] = self.pages_alloc
        st["pages_saved"] = self.pages_asked - self.pages_alloc
        return st


class _SimPrefillJob:
    """Pure-bookkeeping stand-in for ChunkedPrefill in sim-only lanes."""

    __slots__ = ("total", "done_tokens")

    def __init__(self, total: int, start: int = 0):
        self.total = int(total)
        self.done_tokens = int(start)

    def step(self, n: int) -> int:
        take = min(int(n), self.total - self.done_tokens)
        self.done_tokens += take
        return take

    @property
    def done(self) -> bool:
        return self.done_tokens >= self.total


class PrefixSimRunner:
    """Page accounting without execution: the sim-side mirror of a paged
    :class:`SlotRunner`.

    Carries the allocator — :class:`PagePool`, :class:`PrefixIndex`, the
    reserve/alloc/cancel admission protocol and prefill-skip — into
    deterministic pure-sim runs: prompt tokens are synthetic hashables
    (``("T", template, i)`` for the shared span, ``("R", rid, j)`` for the
    suffix), and pages hold no data.
    """

    def __init__(self, max_batch: int, cache_len: int, page_size: int,
                 num_pages: int, prefix_sharing: bool = True):
        self.max_batch = int(max_batch)
        self.cache_len = int(cache_len)
        self.page_size = int(page_size)
        self.pool = PagePool(num_pages)
        self.prefix_index = (PrefixIndex(self.page_size)
                             if prefix_sharing else None)
        self._plans: Dict[int, Dict[str, Any]] = {}
        self._inflight: Dict[int, Dict[str, Any]] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self.prefill_tokens_skipped = 0
        self.pages_asked = 0
        self.pages_alloc = 0

    def _tokens(self, req: Request) -> tuple:
        npre = (min(req.prefix_len, req.prompt_len - 1)
                if req.template is not None else 0)
        return (tuple(("T", req.template, i) for i in range(npre))
                + tuple(("R", req.rid, j)
                        for j in range(req.prompt_len - npre)))

    def pages_for(self, req: Request) -> int:
        n = min(req.prompt_len + req.max_new_tokens, self.cache_len)
        return -(-n // self.page_size)

    def _make_plan(self, req: Request) -> Optional[Dict[str, Any]]:
        total = self.pages_for(req)
        plan: Dict[str, Any] = {"host": self._tokens(req), "shared": [],
                                "matched": 0, "new": total}
        if self.prefix_index is not None:
            m = self.prefix_index.match(plan["host"],
                                        limit=req.prompt_len - 1)
            if m.pages:
                self.pool.incref(m.pages)
            plan.update(shared=list(m.pages), matched=m.tokens,
                        new=total - m.n_pages)
        short = plan["new"] - self.pool.available
        if short > 0 and self.prefix_index is not None:
            self.prefix_index.reclaim(short, self.pool)
        if not self.pool.reserve(plan["new"]):
            if plan["shared"]:
                self.pool.free(plan["shared"])
            return None
        return plan

    def can_admit(self, req: Request) -> bool:
        stale = self._plans.pop(req.rid, None)
        if stale is not None:
            self._release_plan(stale)
        plan = self._make_plan(req)
        if plan is None:
            return False
        self._plans[req.rid] = plan
        return True

    def _release_plan(self, plan: Dict[str, Any]) -> None:
        self.pool.unreserve(plan["new"])
        if plan["shared"]:
            for p in self.pool.free(plan["shared"]):
                if self.prefix_index is not None:
                    self.prefix_index.invalidate_tail(p)

    def start_prefill(self, req: Request):
        plan = self._plans.pop(req.rid, None)
        if plan is None:
            plan = self._make_plan(req)
            if plan is None:
                raise RuntimeError(
                    f"page pool exhausted admitting rid={req.rid}")
        self.prefill_tokens_skipped += plan["matched"]
        job = _SimPrefillJob(req.prompt_len, start=plan["matched"])
        self._inflight[id(job)] = plan
        return job

    def finish_prefill(self, slot: int, req: Request, job) -> None:
        plan = self._inflight.pop(id(job))
        new = self.pool.alloc(plan["new"], reserved=True)
        if new is None:
            raise RuntimeError(
                f"page pool exhausted admitting rid={req.rid}")
        pages = plan["shared"] + new
        self._slot_pages[slot] = pages
        self.pages_asked += len(pages)
        self.pages_alloc += len(new)
        if self.prefix_index is not None:
            self.prefix_index.insert(plan["host"], pages, self.pool)

    def cancel_prefill(self, job) -> None:
        plan = self._inflight.pop(id(job), None)
        if plan is not None:
            self._release_plan(plan)

    def step(self, active_slots: List[int]) -> None:
        pass                        # no execution — the clock does the work

    def release(self, slot: int) -> None:
        released = self.pool.free(self._slot_pages.pop(slot))
        if self.prefix_index is not None:
            for p in released:
                self.prefix_index.invalidate_tail(p)

    def share_stats(self) -> Optional[Dict[str, Any]]:
        if self.prefix_index is None:
            return None
        st = self.prefix_index.stats()
        st["prefill_tokens_skipped"] = self.prefill_tokens_skipped
        st["pages_asked"] = self.pages_asked
        st["pages_alloc"] = self.pages_alloc
        st["pages_saved"] = self.pages_asked - self.pages_alloc
        return st


# ---------------------------------------------------------------------------
# schedulers


class _ServerBase:
    def __init__(self, max_batch: int, cost: StepCostModel,
                 runner: Optional[SlotRunner] = None, tracker=None):
        if runner is not None and runner.max_batch != max_batch:
            raise ValueError(f"runner has {runner.max_batch} slots, "
                             f"scheduler wants {max_batch}")
        self.max_batch = max_batch
        self.cost = cost
        self.runner = runner
        # observability sink: request lifecycle events and the end-of-run
        # scorecard.  Read-only — sim time and scheduling decisions are
        # identical with or without a tracker.
        self.tracker = tracker if tracker is not None else NOOP

    def _prime(self, requests: List[Request]):
        clock, q = SimClock(), EventQueue()
        recs: Dict[int, RequestRecord] = {}
        reqs: Dict[int, Request] = {}
        for r in requests:
            q.push(r.arrival_s, REQUEST_ARRIVAL, r.rid)
            reqs[r.rid] = r
            recs[r.rid] = RequestRecord(
                rid=r.rid, arrival_s=r.arrival_s, deadline_s=r.deadline_s,
                target_tokens=r.max_new_tokens, slo_ttft_s=r.slo_ttft_s)
        return clock, q, recs, reqs

    def _drop_expired(self, waiting: Deque[Request], recs, now: float):
        """Deadline-aware queue shedding: a request whose TTFT budget (or
        completion deadline) is already blown can never contribute goodput.
        The static baseline is deadline-blind and never calls this."""
        kept: Deque[Request] = deque()
        for r in waiting:
            if now > min(r.deadline_s, r.arrival_s + r.slo_ttft_s):
                recs[r.rid].dropped = "expired_in_queue"
                if self.tracker.active:
                    serve_event(self.tracker, "drop", rid=r.rid, t=now,
                                reason="expired_in_queue")
            else:
                kept.append(r)
        return kept

    def _log_summary(self, summary) -> None:
        if self.tracker.active:
            self.tracker.log_summary(summary, kind=SERVE_SUMMARY)


class ContinuousBatchingServer(_ServerBase):
    """Admit-on-free-slot scheduler with deadline eviction."""

    def run(self, requests: List[Request],
            horizon_s: Optional[float] = None):
        clock, q, recs, reqs = self._prime(requests)
        waiting: Deque[Request] = deque()
        active: Dict[int, Request] = {}          # slot -> request
        free = list(range(self.max_batch))[::-1]  # pop() yields slot 0 first

        def drain(now: float):
            while q and q.peek().time <= now + 1e-12:
                e = q.pop()
                if e.kind == REQUEST_ARRIVAL:
                    waiting.append(reqs[e.actor])
                elif e.kind == DEADLINE:
                    self._evict(e.actor, active, recs, free)

        while q or waiting or active:
            drain(clock.now)
            waiting = self._drop_expired(waiting, recs, clock.now)
            # admit-on-free-slot: prefill occupies the device, so each
            # admission charges its cost before the next decode step, and
            # expiry is re-checked per admission
            while free and waiting:
                r = waiting.popleft()
                if (clock.now + self.cost.prefill_s(r.prompt_len)
                        > r.arrival_s + r.slo_ttft_s
                        or clock.now > r.deadline_s):
                    recs[r.rid].dropped = "expired_in_queue"
                    if self.tracker.active:
                        serve_event(self.tracker, "drop", rid=r.rid,
                                    t=clock.now, reason="expired_in_queue")
                    continue
                slot = free.pop()
                rec = recs[r.rid]
                rec.admit_s = clock.now
                clock.advance_by(self.cost.prefill_s(r.prompt_len))
                if self.runner is not None:
                    self.runner.admit(slot, r)
                rec.first_token_s = clock.now
                rec.tokens_out = 1
                if self.tracker.active:
                    serve_event(self.tracker, "admit", rid=r.rid,
                                t=rec.admit_s, slot=slot,
                                ttft_s=rec.first_token_s - rec.arrival_s)
                active[slot] = r
                if r.max_new_tokens <= 1:
                    self._finish(slot, active, recs, free, clock.now)
                else:
                    q.push(r.deadline_s, DEADLINE, r.rid)
                drain(clock.now)
            if active:
                clock.advance_by(self.cost.decode_step_s)
                if self.runner is not None:
                    self.runner.step(sorted(active))
                for slot in sorted(active):
                    rec = recs[active[slot].rid]
                    rec.tokens_out += 1
                    if rec.tokens_out >= rec.target_tokens:
                        self._finish(slot, active, recs, free, clock.now)
                drain(clock.now)
            elif q:
                clock.advance_to(q.peek().time)
        horizon = max(clock.now, horizon_s or 0.0)
        summary = summarize(list(recs.values()), horizon)
        self._log_summary(summary)
        return list(recs.values()), summary

    def _finish(self, slot, active, recs, free, now):
        r = active.pop(slot)
        recs[r.rid].finish_s = now
        free.append(slot)
        if self.runner is not None:
            self.runner.release(slot)
        if self.tracker.active:
            serve_event(self.tracker, "finish", rid=r.rid, t=now, slot=slot,
                        tokens_out=recs[r.rid].tokens_out)

    def _evict(self, rid, active, recs, free):
        for slot, r in list(active.items()):
            if r.rid == rid and recs[rid].finish_s is None:
                active.pop(slot)
                free.append(slot)
                recs[rid].dropped = "slo_miss"
                if self.runner is not None:
                    self.runner.release(slot)
                if self.tracker.active:
                    serve_event(self.tracker, "evict", rid=rid,
                                t=recs[rid].deadline_s, slot=slot,
                                reason="slo_miss",
                                tokens_out=recs[rid].tokens_out)


class StaticBatchingServer(_ServerBase):
    """Legacy discipline: fill the batch, decode to the slowest straggler."""

    def run(self, requests: List[Request],
            horizon_s: Optional[float] = None):
        clock, q, recs, reqs = self._prime(requests)
        waiting: Deque[Request] = deque()
        active: Dict[int, Request] = {}

        def drain(now: float):
            while q and q.peek().time <= now + 1e-12:
                e = q.pop()
                if e.kind == REQUEST_ARRIVAL:
                    waiting.append(reqs[e.actor])

        while q or waiting or active:
            drain(clock.now)
            # deadline-blind: admits everything in order, including requests
            # whose SLO is already unmeetable
            if not active:
                if waiting and (len(waiting) >= self.max_batch or not q):
                    for slot in range(min(self.max_batch, len(waiting))):
                        r = waiting.popleft()
                        rec = recs[r.rid]
                        rec.admit_s = clock.now
                        clock.advance_by(self.cost.prefill_s(r.prompt_len))
                        if self.runner is not None:
                            self.runner.admit(slot, r)
                        rec.first_token_s = clock.now
                        rec.tokens_out = 1
                        if r.max_new_tokens <= 1:
                            rec.finish_s = clock.now
                            if self.runner is not None:
                                self.runner.release(slot)
                        else:
                            active[slot] = r
                elif q:
                    clock.advance_to(q.peek().time)
                else:
                    break       # nothing waiting, nothing arriving
                continue
            # decode until the whole batch is done — no admission mid-flight;
            # finished requests squat their slots but generate nothing more
            live = [s for s in sorted(active)
                    if recs[active[s].rid].finish_s is None]
            clock.advance_by(self.cost.decode_step_s)
            if self.runner is not None:
                self.runner.step(live)
            for slot in live:
                rec = recs[active[slot].rid]
                rec.tokens_out += 1
                if rec.tokens_out >= rec.target_tokens:
                    rec.finish_s = clock.now        # slot stays squatted
            if all(recs[r.rid].finish_s is not None
                   for r in active.values()):
                if self.runner is not None:
                    for slot in active:
                        self.runner.release(slot)
                active.clear()
        horizon = max(clock.now, horizon_s or 0.0)
        summary = summarize(list(recs.values()), horizon)
        self._log_summary(summary)
        return list(recs.values()), summary

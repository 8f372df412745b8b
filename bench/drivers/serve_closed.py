"""Traffic loop of the serving cells: a closed loop of clients, one per slot,
through the port's ``serve/engine.py::SlotRunner`` with paged caches.

A finished request's slot is refilled once the decode step that finished
it has returned: ``release``, then the client's next request is prefilled
through the runner's chunked path (``start_prefill``, ``prefill_chunk``
tokens a ``step`` of its job, ``finish_prefill``, which samples its first
token).  Between admissions every active slot decodes one greedy token a
``step``.  A token's time is the host clock when the call that made it
returned (each admission and each ``step`` ends in a copy to the host).

Set-up makes the weights and the runner, fills every slot with its
client's first request (cut to a residual output length: the loop opens in
its steady state) and runs one loop iteration (a decode step and the
refills it causes), which warms the decode step.  The window starts with
the next decode step.  Once ``--seconds`` have passed, it ends at the
return of the first decode step that finishes a request: that step's
tokens count, the refill it causes does not.  So every window ends at the
same phase of the loop, just before a refill, whatever the deadline falls
in.  With ``--trace 1`` those slots are refilled and a span of
``trace_steps`` further iterations runs under the profiler.  Once the
window has closed and the program's state is freed, the plain reference
reads the requests that were served tokens (those finished and those
still in their slots, each with every token it was served): by length,
the longest first, until it has compared one that is not set aside for a
routing near-tie, then the rest in an order drawn from the seed, until
``compared_requests`` of them have been compared or none are left.

Workload keys: ``clients``, ``cache_len``, ``page_size``,
``prefill_chunk``, ``prompt_len``, ``output_len``, ``pool``,
``steady_start``, ``compared_requests``, ``kernels``, ``trace_steps``,
``limits``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import flops, program, stats, trace, traffic
from bench import weights as W
from bench.reference.serve import token_gaps

SAMPLE_STREAM = 4


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Loop:
    """The closed loop's state: which request each slot serves, each
    request's token times, and the host time of each call."""

    def __init__(self, spec, runner, pool):
        self.spec, self.runner, self.pool = spec, runner, pool
        self.cfg, self.chunk = spec.cfg, int(spec.wl["prefill_chunk"])
        self.slots = {}                 # slot -> traffic.Req
        self.times = {}                 # rid -> [host times of its tokens]
        self.logits = {}                # rid -> [its tokens' logits, device]
        self.finished = []              # traffic.Req, in finishing order
        self.admit_s, self.admits, self.step_s, self.steps = 0.0, 0, 0.0, 0
        self.flops = 0
        self.kv_lens = None             # per decode step, when recording
        self.step_end = None            # host time the last step returned

    def admit(self, slot: int) -> None:
        """Prefill the next request into a free slot (and the one after,
        if its first token is its last)."""
        req = self.pool.next()
        self.runner.prompts[req.rid] = torch.from_numpy(req.prompt)[None]
        r = program.request(req.rid, req.prompt.size, req.max_new)
        t = time.perf_counter()
        with torch.profiler.record_function("bench.admit"):
            job = self.runner.start_prefill(r)
            while not job.done:
                job.step(self.chunk)
            self.runner.finish_prefill(slot, r, job)
        t1 = time.perf_counter()
        self.admit_s += t1 - t
        self.admits += 1
        self.flops += flops.prefill(self.cfg, req.prompt.size)
        self.times[req.rid] = [t1]
        self.logits[req.rid] = [self.runner.chosen_logits[0]]
        self.slots[slot] = req
        if self._retire(slot):
            self.admit(slot)

    def _retire(self, slot: int) -> bool:
        """Release the slot if its request has all its tokens."""
        req = self.slots[slot]
        if len(self.runner.generated[req.rid]) < req.max_new:
            return False
        with torch.profiler.record_function("bench.release"):
            self.runner.release(slot)
        del self.slots[slot]
        self.runner.prompts.pop(req.rid)
        self.finished.append(req)
        return True

    def step(self) -> list:
        """One decode step of every active slot; returns the slots it
        freed, left for ``refill``."""
        active = sorted(self.slots)
        lens = [self.slots[s].prompt.size
                + len(self.runner.generated[self.slots[s].rid])
                for s in active]
        if self.kv_lens is not None:
            self.kv_lens.append(lens)
        t = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            self.runner.step(active)
        t1 = time.perf_counter()
        self.step_end = t1
        self.step_s += t1 - t
        self.steps += 1
        self.flops += sum(flops.decode_token(self.cfg, n) for n in lens)
        chosen = self.runner.chosen_logits
        for s in active:
            self.times[self.slots[s].rid].append(t1)
            self.logits[self.slots[s].rid].append(chosen[s])
        return [s for s in active if self._retire(s)]

    def refill(self, freed: list) -> None:
        for s in freed:
            self.admit(s)

    def iteration(self) -> None:
        self.refill(self.step())


def _read_order(spec, n: int) -> list:
    """An order of ``n`` served requests drawn from the seed: the order in
    which the reference reads them once it has compared the longest that
    is not set aside."""
    rng = np.random.default_rng(W.sub_seed(spec.seed, SAMPLE_STREAM))
    return rng.permutation(n).tolist()


def run(spec) -> dict:
    wl, cfg, dev = spec.wl, spec.cfg, spec.device
    program.prebuild(wl["kernels"], dev)
    weights = W.make(cfg, spec.seed, dev)
    program.check_params(cfg, weights)
    spec.log(f"kernels built or found, weights made on the card: "
             f"{time.time() - spec.t_start:.3f} s after start")
    slots, cache_len, page = wl["clients"], wl["cache_len"], wl["page_size"]
    pages = slots * (-(-cache_len // page))
    runner = program.slot_runner(weights, cfg, dev, max_batch=slots,
                                 cache_len=cache_len, page_size=page,
                                 num_pages=pages)
    pool = traffic.RequestPool(wl, spec.seed, cfg["vocab_size"])
    too_long = int(pool.prompts.max() + pool.outputs.max())
    if too_long > cache_len:
        raise ValueError(f"requests of {too_long} tokens overflow the "
                         f"cache of {cache_len}")
    loop = Loop(spec, runner, pool)
    for slot in range(slots):
        loop.admit(slot)
    loop.iteration()
    _sync(dev)
    setup_s = time.time() - spec.t_start
    spec.log(f"set-up {setup_s:.3f} s")

    # the window: from a decode step to the first decode step past the
    # deadline that frees a slot, its refill left out
    loop.admit_s, loop.admits, loop.step_s, loop.steps = 0.0, 0, 0.0, 0
    loop.flops = 0
    t0 = time.perf_counter()
    deadline = t0 + spec.seconds
    while True:
        freed = loop.step()
        if freed and loop.step_end >= deadline:
            break
        loop.refill(freed)
    t1 = loop.step_end
    window_s = t1 - t0
    gaps = stats.window_gaps(loop.times, t0, t1)
    tokens = stats.window_count(loop.times, t0, t1)
    attempted = sum(1 for ts in loop.times.values()
                    if any(t0 < t <= t1 for t in ts))
    record = {"kind": "serve", "cfg": cfg, "setup_s": setup_s,
              "window_s": window_s,
              "tokens": tokens, "itl_gaps_s": gaps, "steps": loop.steps,
              "decode_host_s": loop.step_s, "admits": loop.admits,
              "admit_host_s": loop.admit_s, "flops": loop.flops,
              "attempted": attempted, "failed": 0}
    spec.log(f"window {window_s:.3f} s: {loop.steps} steps, {loop.admits} "
             f"admissions, {tokens} tokens, {len(gaps)} gaps; ended "
             f"{t1 - deadline:.3f} s past the deadline, at a step that "
             f"finished {len(freed)} requests")
    if spec.trace:
        loop.refill(freed)
        loop.kv_lens = []
        def span():
            for _ in range(wl["trace_steps"]):
                loop.iteration()

        record["profile"] = trace.profile_span(span, loop.iteration, dev)
        # the device span's steps only: the labelled span came after
        record["profile"]["kv_lens"] = loop.kv_lens[:wl["trace_steps"]]
        loop.kv_lens = None
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)
    record["device_kind"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")

    # what was served, on the host, then the program's state freed
    done = {r.rid for r in loop.finished}
    every = loop.finished + [loop.slots[s] for s in sorted(loop.slots)]
    order = [every[i] for i in _read_order(spec, len(every))]
    served = [(torch.from_numpy(r.prompt),
               torch.tensor(runner.generated[r.rid], dtype=torch.int64),
               torch.stack(loop.logits[r.rid]).cpu())
              for r in order]
    record["sound"] = all(
        s.numel() == lg.numel() and (s.numel() == r.max_new if r.rid in done
                                     else s.numel() < r.max_new)
        for (_, s, lg), r in zip(served, order))
    del runner, loop, weights
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    read = token_gaps(cfg, W.make(cfg, spec.seed, dev),
                      (tuple(t.to(dev) for t in x) for x in served),
                      control=spec.wl.get("control", ""),
                      want=spec.wl["compared_requests"], longest=True)
    n_read = len(read["read"])
    record["served"] = [(order[i].rid,) + served[i] for i in read["read"]]
    record["compared"] = {"token_gap": read["gap"]}
    record["reference"] = read
    record["sound"] = record["sound"] and read["tokens"] > 0
    length = {i: row[0] + row[1] for i, row in zip(read["read"],
                                                    read["requests"])}
    first = read["read"][0]
    compared = [length[i] for i in read["read"]
                if i not in read["set_aside"]]
    spec.log(f"reference {time.perf_counter() - t_ref:.3f} s: of "
             f"{len(served)} requests served tokens, drew {n_read} "
             f"({len(done & {order[i].rid for i in read['read']})} "
             f"finished), set aside {read['near_ties']} for a routing "
             f"near-tie ({read['near_tie_tokens']} tokens), compared "
             f"{read['compared']} ({read['tokens']} tokens); the longest "
             f"served, {length[first]} tokens, "
             f"{'set aside' if first in read['set_aside'] else 'compared'}"
             f"; the longest compared {max(compared, default=0)} tokens; "
             f"(P, n, gap, margin) a request drawn: {read['requests']}")
    return record

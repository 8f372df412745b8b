"""Streaming request arrivals from the paper's Table I rate distributions.

Carried over from ``repro/serve/requests.py`` with its numpy logic
unchanged: equal seeds give identical arrival traces in both packages.

ScaDLES models edge devices whose *training* samples stream in at Table I
rates; serving faces the mirror image — clients whose *prompts* stream in at
those rates.  A client with token rate ``r`` has gathered a ``prompt_len``
prompt every ``prompt_len / r`` seconds (``core.streams.streaming_latency``
applied to tokens instead of samples), so per-client request interarrival is
exactly the paper's streaming wait; S1 (slow, high-variance uniform) gives a
sparse trickle and S2 (fast) a near-overload front, which is the regime where
batching discipline decides goodput (benchmarks/serving.py).

Every request carries an absolute deadline: ``arrival + slo_ttft + slo_tpot *
max_new_tokens`` — a token-budgeted SLO in the Deep-Edge style.  Schedulers
drop (or evict) work that cannot meet it; ``metrics.summarize`` counts only
deadline-met tokens toward goodput.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.streams import TABLE_I, StreamDist


def assign_templates(reqs: List["Request"], n_templates: int,
                     prefix_len: int, zipf_s: float = 1.1,
                     seed: int = 0) -> List["Request"]:
    """Tag requests with Zipf-reused shared-prefix templates.

    Template popularity follows a normalised Zipf law (rank ``k`` drawn with
    probability ∝ ``k^-zipf_s``) — the few-hot-system-prompts shape of
    production traffic.  Draws come from their own PRNG stream, so decorating
    a trace never perturbs the arrival process that generated it (the legacy
    RNG draw sequences stay byte-identical).
    """
    if n_templates <= 0 or prefix_len <= 0 or not reqs:
        return reqs
    rng = np.random.default_rng((seed, 0x7E3F))
    ranks = np.arange(1, n_templates + 1, dtype=np.float64)
    probs = ranks ** -float(zipf_s)
    probs /= probs.sum()
    draws = rng.choice(n_templates, size=len(reqs), p=probs)
    return [dataclasses.replace(
        r, template=int(draws[i]),
        prefix_len=min(int(prefix_len), max(r.prompt_len - 1, 0)))
        for i, r in enumerate(reqs)]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request in sim time.

    Two SLO clauses gate goodput: the first token must land within
    ``slo_ttft_s`` of arrival AND the request must complete by
    ``deadline_s`` (arrival + TTFT budget + per-token budget).
    """
    rid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    deadline_s: float
    slo_ttft_s: float = float("inf")
    client: int = 0
    # shared-prefix trace mode: requests with the same ``template`` open with
    # the same ``prefix_len`` prompt tokens (system prompt / few-shot header),
    # so a prefix-sharing runner can dedupe their KV pages.  ``None`` =
    # fully unique prompt (the legacy trace).
    template: Optional[int] = None
    prefix_len: int = 0


@dataclasses.dataclass
class RequestStream:
    """Per-client request arrival process on a Table I rate distribution.

    Each of ``n_clients`` samples a token-streaming rate from ``dist`` (same
    draw semantics as the training-side ``StreamSimulator``); its requests
    become ready every ``prompt_len / rate`` seconds from a random initial
    phase.  ``generate`` returns the merged arrival-ordered request list.
    """
    dist: Union[str, StreamDist]
    n_clients: int = 16
    prompt_len: int = 64
    max_new_tokens: int = 32
    slo_ttft_s: float = 0.75
    slo_tpot_s: float = 0.05
    seed: int = 0
    # mixed workload: each request draws its prompt length uniformly from
    # this tuple (a client's next arrival waits for the *drawn* prompt to
    # stream in, so long prompts are also rarer per unit time).  None keeps
    # the fixed-length stream — and its exact RNG draw sequence, which the
    # perf-gate baselines pin.
    prompt_lens: Optional[Sequence[int]] = None
    # shared-prefix trace mode (``assign_templates``): n_templates > 0 tags
    # each request with a Zipf-reused template whose first
    # ``template_prefix_len`` prompt tokens are shared.  Off (0) by default;
    # drawn from a separate PRNG stream, so the arrival trace — and the
    # pinned legacy draw sequences — are unchanged either way.
    n_templates: int = 0
    template_prefix_len: int = 0
    template_zipf: float = 1.1

    def __post_init__(self):
        if isinstance(self.dist, str):
            self.dist = TABLE_I[self.dist]
        if self.prompt_lens is not None:
            self.prompt_lens = tuple(int(p) for p in self.prompt_lens)

    def deadline_for(self, arrival_s: float) -> float:
        return (arrival_s + self.slo_ttft_s
                + self.slo_tpot_s * self.max_new_tokens)

    def generate(self, horizon_s: float) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        rates = self.dist.sample(rng, self.n_clients).astype(np.float64)
        if self.prompt_lens is None:
            interarrival = self.prompt_len / rates         # streaming_latency
            phase = rng.uniform(0.0, interarrival)         # desynchronised
            reqs: List[Request] = []
            for c in range(self.n_clients):
                t = float(phase[c])
                while t < horizon_s:
                    reqs.append(Request(
                        rid=0, arrival_s=t, prompt_len=self.prompt_len,
                        max_new_tokens=self.max_new_tokens,
                        deadline_s=self.deadline_for(t),
                        slo_ttft_s=self.slo_ttft_s, client=c))
                    t += float(interarrival[c])
        else:
            mean_len = float(np.mean(self.prompt_lens))
            phase = rng.uniform(0.0, mean_len / rates)
            reqs = []
            for c in range(self.n_clients):
                t = float(phase[c])
                while t < horizon_s:
                    plen = int(rng.choice(self.prompt_lens))
                    reqs.append(Request(
                        rid=0, arrival_s=t, prompt_len=plen,
                        max_new_tokens=self.max_new_tokens,
                        deadline_s=self.deadline_for(t),
                        slo_ttft_s=self.slo_ttft_s, client=c))
                    t += plen / float(rates[c])    # gather time of this prompt
        reqs.sort(key=lambda r: r.arrival_s)
        reqs = [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]
        return assign_templates(reqs, self.n_templates,
                                self.template_prefix_len,
                                self.template_zipf, self.seed)


@dataclasses.dataclass
class BurstyRequestStream:
    """Aggregate bursty arrivals: the millions-of-users front view.

    Instead of per-client token streams, model the *aggregate* request
    arrival at a serving endpoint as a non-homogeneous Poisson process:
    ``base_rate`` requests/s, multiplied by ``burst_mult`` for
    ``burst_len_s`` out of every ``burst_every_s`` (flash-crowd cadence).
    Generated by thinning, so the trace is exact for the piecewise-constant
    rate.  Prompt lengths draw uniformly from ``prompt_lens`` — the mixed
    workload where chunked-interleaved prefill earns its TTFT tail.
    """
    base_rate: float = 40.0
    burst_mult: float = 4.0
    burst_every_s: float = 4.0
    burst_len_s: float = 1.0
    prompt_lens: Sequence[int] = (32, 128)
    max_new_tokens: int = 32
    slo_ttft_s: float = 0.75
    slo_tpot_s: float = 0.05
    seed: int = 0
    # shared-prefix trace mode, as in RequestStream (separate PRNG stream;
    # the thinned Poisson arrival draws are untouched)
    n_templates: int = 0
    template_prefix_len: int = 0
    template_zipf: float = 1.1

    def rate_at(self, t: float) -> float:
        in_burst = (t % self.burst_every_s) < self.burst_len_s
        return self.base_rate * (self.burst_mult if in_burst else 1.0)

    def deadline_for(self, arrival_s: float) -> float:
        return (arrival_s + self.slo_ttft_s
                + self.slo_tpot_s * self.max_new_tokens)

    def generate(self, horizon_s: float) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        lam_max = self.base_rate * max(1.0, self.burst_mult)
        reqs: List[Request] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / lam_max))
            if t >= horizon_s:
                break
            if rng.uniform() > self.rate_at(t) / lam_max:
                continue            # thinned: outside the current rate
            plen = int(rng.choice(tuple(self.prompt_lens)))
            reqs.append(Request(
                rid=len(reqs), arrival_s=t, prompt_len=plen,
                max_new_tokens=self.max_new_tokens,
                deadline_s=self.deadline_for(t),
                slo_ttft_s=self.slo_ttft_s, client=0))
        return assign_templates(reqs, self.n_templates,
                                self.template_prefix_len,
                                self.template_zipf, self.seed)

"""ScaDLES trainer: the paper's full per-iteration routine (Fig 5).

Counterpart of ``repro/core/scadles.py``.  Simulates N edge devices with
``torch.func.vmap`` over a device axis (bit-for-bit synchronous
data-parallel semantics):

  streams -> buffers (persistence|truncation) -> rate-proportional batches ->
  [data injection] -> per-device grads -> [adaptive compression] ->
  weighted aggregation (Eqn 4) -> linear-scaled SGD -> simulated edge clock.

``weighted=False`` gives the conventional-DDL baseline (fixed batch, uniform
mean, full waits) the paper compares against.  With ``fleet`` set, the
event-driven heterogeneous clock (``repro_torch.fleet``) replaces the
lockstep one, and relaxed sync policies commit stale gradients evaluated at
the parameters each device read.

Everything on the host (streams, buffers, clock, fleet engine, the numpy
batch draw, compression decisions) is the reference's logic, so equal seeds
give identical host state.  The batch goes to ``cfg.device`` once a round;
gradients, compression, aggregation and the update run there.  No kernel of
``repro_torch.kernels`` is on this path, as in the reference: compression is
the exact ``sparsify_mask`` and the momentum update is inline.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch import resolve_device
from repro_torch.core import buffer as buf_lib
from repro_torch.core import compression as comp_lib
from repro_torch.core import injection as inj_lib
from repro_torch.core import simclock
from repro_torch.core import streams as stream_lib
from repro_torch.core.weighted_agg import (linear_scaled_lr,
                                           skew_corrected_rates,
                                           weighted_aggregate)
from repro_torch.obs.callbacks import RoundObserver
from repro_torch.obs.tracker import NOOP
from repro_torch.tree import leaves, ravel, tree_map, unflatten


@dataclasses.dataclass
class ScaDLESConfig:
    n_devices: int = 16
    dist: str = "S1"                     # Table I key
    policy: str = buf_lib.PERSISTENCE
    weighted: bool = True                # False => conventional DDL
    ddl_batch: int = 64                  # fixed batch for conventional DDL
    b_min: int = 8
    b_max: int = 1024
    base_lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 0.0
    linear_lr_scaling: bool = True
    compression: Optional[Tuple[float, float]] = None   # (CR, delta)
    injection: Optional[Tuple[float, float]] = None     # (alpha, beta)
    # local SGD steps between synchronisations (1 = per-iteration sync, the
    # paper's main setting; >1 = FedAvg-style partial work)
    local_steps: int = 1
    # heterogeneous-fleet simulation (repro_torch.fleet.FleetConfig); None
    # keeps the legacy lockstep EdgeClock.  The engine schedules each
    # device's stream/compute/comm events, applies the live sync policy and
    # churn, and feeds the realised participant set into the aggregation.
    fleet: Optional[Any] = None
    # relaxed-consistency commits: how many parameter snapshots to keep so a
    # stale commit's gradient is evaluated at the version the device read.
    # A commit whose read version fell off the ring aggregates with weight
    # 0.  None derives the depth from the live policy, capped at
    # max(8, 4 * n_devices)
    param_ring: Optional[int] = None
    # damp a stale gradient's aggregation weight by 1/(1+s), s = commits the
    # participant's model view is behind
    staleness_damping: bool = True
    # --- non-IID data planes that report ``label_divergence()`` ---------
    # skew-corrected aggregation: rate weight times label coverage
    # c_i = clip(1 - TV_i, skew_floor, 1)
    skew_weighting: bool = False
    skew_floor: float = 0.05
    # w = w / (1 + s * (1 + noniid_damping * TV_i)) on the carry path; 0.0
    # keeps the classic 1/(1+s)
    noniid_damping: float = 0.0
    # observability sink (repro_torch.obs.Tracker).  None keeps the inert
    # NOOP: no per-round records and no flop counting; tracking reads host
    # state only, so a tracked run is bit-exact with an untracked one
    tracker: Optional[Any] = None
    seed: int = 0
    intra_jitter: float = 0.0
    sample_bytes: int = 3072             # 3 KB / CIFAR image (paper Fig 10)
    grad_floats: Optional[float] = None  # default: model size
    compute_sec_per_iter: float = 1.2    # K80 calibration (Table II)
    bandwidth_gbps: float = 5.0
    # where params, gradients and the update live; "cpu" must be asked for
    device: str = "cuda"


class ScaDLESTrainer:
    """model: dict with ``init(gen, device)``, ``per_sample_loss(params, x,
    y) -> (b,)`` and ``predict(params, x) -> logits`` (``models/mlp.py``).
    data: ``DeviceDataSource`` (``repro_torch.data``).

    ``on_phase(name)``, if set, is called as each phase of a round ends:
    ``"host"`` (rates, buffers, batch draw, injection), ``"upload"``,
    ``"grads"``, ``"compress"``, ``"aggregate"``, ``"update"``; a caller may
    record a CUDA event or read a host clock there.
    """

    def __init__(self, model, data, cfg: ScaDLESConfig):
        self.device = resolve_device(cfg.device)
        self.model, self.data, self.cfg = model, data, cfg
        self.on_phase: Optional[Callable[[str], None]] = None
        self.rng = np.random.default_rng(cfg.seed)
        self.sim = stream_lib.StreamSimulator(
            stream_lib.TABLE_I[cfg.dist], cfg.n_devices, seed=cfg.seed,
            intra_jitter=cfg.intra_jitter)
        self.buffers = [buf_lib.CountingBuffer(policy=cfg.policy)
                        for _ in range(cfg.n_devices)]
        # data-plane extensions, discovered by attribute so the plain
        # DeviceDataSource runs untouched:
        #   time_aware         -> pass t_sim into batches() (drift / diurnal)
        #   on_arrivals(a)     -> mirror arrivals into the loader's buffers
        #   label_divergence() -> per-device TV-to-global-mix skew signal
        self._data_time_aware = bool(getattr(data, "time_aware", False))
        self._on_arrivals = getattr(data, "on_arrivals", None)
        self._div_fn = getattr(data, "label_divergence", None)
        self.params = model["init"](torch.Generator().manual_seed(cfg.seed),
                                    self.device)
        self.momentum_state = tree_map(torch.zeros_like, self.params)
        actual_floats = sum(x.numel() for x in leaves(self.params))
        # the wire-model size (clock + floats accounting) may be calibrated
        # to a larger reference model; compression k uses the actual size
        n_floats = cfg.grad_floats or actual_floats
        self.compressor = (comp_lib.AdaptiveCompressor(*cfg.compression)
                           if cfg.compression else None)
        self.clock = simclock.EdgeClock(simclock.EdgeClockConfig(
            bandwidth_gbps=cfg.bandwidth_gbps,
            compute_sec_per_iter=cfg.compute_sec_per_iter,
            n_devices=cfg.n_devices, grad_floats=n_floats))
        self.n_floats = int(n_floats)
        self.actual_floats = int(actual_floats)
        self.prev_iter_time = 1.0
        self.history: List[Dict[str, float]] = []
        self.tracker = cfg.tracker if cfg.tracker is not None else NOOP
        self._obs = RoundObserver(self.tracker, n_devices=cfg.n_devices)
        # fleet mode: the event-driven clock replaces the lockstep EdgeClock
        # (lazy import: repro_torch.fleet depends on core.simclock)
        self.fleet = None
        if cfg.fleet is not None:
            from repro_torch import fleet as fleet_lib
            self.fleet = fleet_lib.FleetEngine(cfg.fleet, self.clock.cfg,
                                               tracker=self.tracker)
        self._online_frac = np.ones(cfg.n_devices)
        # relaxed-consistency commits: a straggler's gradient commits rounds
        # after its work started and is evaluated at the parameters it
        # *read*.  A ring of flat parameter snapshots, keyed by the engine's
        # model version, supplies them; each device's start-round batch (and
        # rate) stays pending so the late gradient is recomputed exactly.
        #
        # The ring and the pending batch live on ``self.device``, where the
        # reference keeps host numpy copies: on the card a host ring would
        # copy the params back every round and send a (D, n) stack up every
        # commit, and a host pending store would send the whole batch up
        # again each round.  The ring is at most max(8, 4 D) snapshots of n
        # floats (50 MB at 16 devices and the edge MLP's 197 322), and the
        # bits are the same on either side.
        if self.fleet is not None:
            self._unravel_params = ravel(self.params)[1]
            self._param_ring: "OrderedDict[int, torch.Tensor]" = OrderedDict()
            self._pending_batch = None           # (xs, ys, masks) tensors
            self._pending_rates = np.zeros(cfg.n_devices)
            self._pending_valid = np.zeros(cfg.n_devices, bool)
            self._pending_debit = np.zeros(cfg.n_devices)   # buffer samples
            self._pending_comp = np.zeros(cfg.n_devices, bool)  # use_comp
            self._pending_div = np.zeros(cfg.n_devices)     # start-round TV
        self._step_fn, self._carry_step_fn = self._build_step()

    # ------------------------------------------------------------------
    def _mark(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def _build_step(self):
        cfg = self.cfg
        per_sample_loss = self.model["per_sample_loss"]
        k = self.compressor.k_for(self.actual_floats) if self.compressor else 1

        def loss(p, x, y, mask):
            per = per_sample_loss(p, x, y)
            return torch.sum(per * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)

        grad_value = grad_and_value(loss)

        def device_grad(params, x, y, mask):
            if cfg.local_steps <= 1:
                g, l = grad_value(params, x, y, mask)
                return l, g
            # FedAvg-style partial work: E local SGD steps, the parameter
            # delta acts as the device's pseudo-gradient for aggregation
            p, losses = params, []
            for _ in range(cfg.local_steps):
                g, l = grad_value(p, x, y, mask)
                p = tree_map(lambda a, b: a - cfg.base_lr * b, p, g)
                losses.append(l)
            pseudo_grad = tree_map(lambda a, b: (a - b) / cfg.base_lr,
                                   params, p)
            return torch.mean(torch.stack(losses)), pseudo_grad

        def core(params, mom, xs, ys, masks, rates_eff, agg_w, use_comp,
                 dev_params=None, part_f=None):
            # per-device grads (vmap == synchronous DDP).  Relaxed modes map
            # over a per-device parameter axis as well: a stale committer's
            # gradient is evaluated at the snapshot of the version it read
            if dev_params is None:
                losses, grads = vmap(device_grad, in_dims=(None, 0, 0, 0))(
                    params, xs, ys, masks)
            else:
                losses, grads = vmap(device_grad, in_dims=(0, 0, 0, 0))(
                    dev_params, xs, ys, masks)
            self._mark("grads")
            # optional compression of each device's gradient.  Relaxed modes
            # pass a per-device (D, 1) decision: a late commit replays the
            # compression choice of its *start* round
            flat, unflatten_one = comp_lib.flatten_stacked_grads(grads)
            if cfg.compression:
                comp = torch.stack([comp_lib.sparsify_mask(v, k)
                                    for v in flat])
                gap = torch.mean(vmap(comp_lib.energy_gap)(flat, comp))
                if isinstance(use_comp, torch.Tensor):
                    flat_used = torch.where(use_comp, comp, flat)
                else:
                    flat_used = comp if use_comp else flat
            else:
                gap = torch.zeros((), device=flat.device)
                flat_used = flat
            grads = vmap(unflatten_one)(flat_used)
            self._mark("compress")
            # Eqn 4b with participation-masked weights (rates for ScaDLES,
            # uniform for conventional DDL); relaxed modes pass
            # pre-normalized, staleness-damped weights
            g = weighted_aggregate(grads, agg_w, normalize=dev_params is None)
            self._mark("aggregate")
            # linear LR scaling from the realised (participating) rates
            if cfg.weighted and cfg.linear_lr_scaling:
                lr = linear_scaled_lr(cfg.base_lr, rates_eff,
                                      cfg.ddl_batch * cfg.n_devices)
            else:
                lr = torch.tensor(cfg.base_lr, dtype=torch.float32,
                                  device=flat.device)
            # momentum SGD, leaf by leaf
            new = [(cfg.momentum * m + gg.to(m.dtype) + cfg.weight_decay * p)
                   for m, gg, p in zip(leaves(mom), leaves(g),
                                       leaves(params))]
            mom = unflatten(mom, new)
            params = unflatten(params, [p - lr * m2 for p, m2 in
                                        zip(leaves(params), new)])
            self._mark("update")
            # report loss over devices that actually trained this round (in
            # relaxed modes: over this commit's participants only)
            has_data = (torch.sum(masks, dim=1) > 0).to(losses.dtype)
            if part_f is not None:
                has_data = has_data * part_f
            loss_out = (torch.sum(losses * has_data)
                        / torch.clamp(torch.sum(has_data), min=1.0))
            return params, mom, loss_out, gap

        def step(params, mom, xs, ys, masks, rates_eff, agg_w, use_comp):
            return core(params, mom, xs, ys, masks, rates_eff, agg_w,
                        use_comp)

        carry_step = None
        if self.fleet is not None:
            unravel = self._unravel_params

            def carry_step(params, mom, dev_flat, xs, ys, masks, part_f,
                           rates_eff, agg_w, use_comp):
                return core(params, mom, xs, ys, masks, rates_eff, agg_w,
                            use_comp[:, None], dev_params=unravel(dev_flat),
                            part_f=part_f)

        return step, carry_step

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        """A host array as a tensor on the trainer's device."""
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    # -- relaxed-consistency commit machinery ---------------------------
    def _use_carry(self) -> bool:
        """Whether the upcoming round must run the snapshot-ring commit
        path: its policy can carry work across commits, or older-policy work
        is still in flight."""
        return (self.fleet.next_policy().can_carry()
                or bool(self.fleet.busy_until)
                or bool(self._pending_valid.any()))

    def _ring_depth_now(self) -> Tuple[int, int]:
        """(soft, hard) ring depths for the upcoming round: an explicit
        ``cfg.param_ring`` is a hard staleness bound; otherwise the soft
        target comes from the current policy and the hard cap is
        max(soft, 8, 4 n)."""
        if self.cfg.param_ring is not None:
            depth = max(int(self.cfg.param_ring), 1)
            return depth, depth
        soft = self.fleet.next_policy().ring_depth(self.cfg.n_devices)
        return soft, max(soft, 8, 4 * self.cfg.n_devices)

    def _ring_push(self, version: int) -> None:
        """Snapshot current params under ``version``, trimming the oldest.
        With policy-derived sizing, versions still read by in-flight work
        are protected; the hard cap (and any explicit ``cfg.param_ring``)
        evicts unconditionally."""
        self._param_ring[version] = ravel(self.params)[0]
        soft, hard = self._ring_depth_now()
        while len(self._param_ring) > hard:
            self._param_ring.popitem(last=False)
        floor_v = min((int(self.fleet.read_version[i])
                       for i in self.fleet.busy_until), default=None)
        while len(self._param_ring) > soft:
            oldest = next(iter(self._param_ring))
            if floor_v is not None and oldest >= floor_v:
                break
            self._param_ring.popitem(last=False)

    def _ring_params(self, read_version: np.ndarray):
        """Per-device stale params (D, n) from the ring, plus a bool mask of
        devices whose read version has been evicted (too stale to apply)."""
        newest = next(reversed(self._param_ring))
        rows, evicted = [], np.zeros(self.cfg.n_devices, bool)
        for i in range(self.cfg.n_devices):
            row = self._param_ring.get(int(read_version[i]))
            if row is None:
                row = self._param_ring[newest]
                evicted[i] = True
            rows.append(row)
        return torch.stack(rows), evicted

    def _plan_carry_commit(self, res, batches, rates, batch, debited,
                           use_comp, div=None):
        """Assemble the step args for a relaxed-consistency commit: update
        the pending store with this round's fresh starters (``batch`` is the
        round's (xs, ys, masks) on the device), look up each committer's
        read-version params in the ring, and build the staleness-damped
        aggregation weights.  Returns (part, step_args)."""
        cfg = self.cfg
        started_data = res.started & (batches > 0)
        if self._pending_batch is None:
            self._pending_batch = [torch.zeros_like(a) for a in batch]
        rows = np.flatnonzero(started_data)
        if rows.size:
            sel = torch.as_tensor(rows).to(self.device)
            for store, new in zip(self._pending_batch, batch):
                store.index_copy_(0, sel, new.index_select(0, sel))
        self._pending_rates[started_data] = rates[started_data]
        self._pending_valid[started_data] = True
        self._pending_valid[res.crashed] = False
        self._pending_debit[started_data] = debited[started_data]
        self._pending_comp[started_data] = use_comp
        # divergence is pinned at *start* time like everything else pending
        self._pending_div[started_data] = (div[started_data]
                                           if div is not None else 0.0)
        # a live switch into backup-workers can cancel in-flight work a
        # relaxed policy had been carrying: the straggler loses its
        # gradient, not its samples — refund the debit from its start round
        for i in res.dropped:
            if self._pending_valid[i]:
                self.buffers[i].refund(self._pending_debit[i])
                self._pending_valid[i] = False
                self._pending_debit[i] = 0.0
        dev_flat, evicted = self._ring_params(self.fleet.read_version)
        # devices with live pending work this round (committers included):
        # the basis for the fleet-wide LR scaling below
        active = self._pending_valid.copy()
        # a commit contributes iff its start-round batch exists and the
        # params it read are still in the ring
        part = res.part & active & ~evicted
        # a committer zero-weighted by ring eviction loses its gradient, not
        # its samples: refund the debit from its start round
        for i in np.flatnonzero(res.part & active & evicted):
            self.buffers[i].refund(self._pending_debit[i])
        # the engine freed every res.part device: their pending work is
        # consumed (trained) or discarded (refunded above) exactly once
        self._pending_valid[res.part] = False
        self._pending_debit[res.part] = 0.0
        stale = np.maximum(res.staleness, 0)
        agg_base = (self._pending_rates.astype(np.float64) if cfg.weighted
                    else np.ones(cfg.n_devices))
        if cfg.skew_weighting and self._div_fn is not None:
            agg_base = skew_corrected_rates(agg_base, self._pending_div,
                                            cfg.skew_floor)
        w = agg_base * part
        total = w.sum()
        if total > 0:
            w = w / total
        if cfg.staleness_damping:
            # damp each gradient post-normalization, so a lone async
            # committer keeps the 1/(1+s) factor
            if cfg.noniid_damping and self._div_fn is not None:
                w = w / (1.0 + stale * (1.0 + cfg.noniid_damping
                                        * self._pending_div))
            else:
                w = w / (1.0 + stale)
        # linear LR scaling sees the whole fleet's realised rates, not just
        # this commit's participants
        rates_eff = self._pending_rates * active
        px, py, pm = self._pending_batch
        return part, [self.params, self.momentum_state, dev_flat, px, py, pm,
                      self._tensor(part), self._tensor(rates_eff),
                      self._tensor(w),
                      self._tensor(self._pending_comp, torch.bool)]

    # ------------------------------------------------------------------
    def run(self, steps: int, eval_every: int = 0,
            eval_fn: Optional[Callable] = None) -> List[Dict[str, float]]:
        cfg = self.cfg
        for t in range(steps):
            # time-aware rate curves modulate the Table I draw on the sim
            # clock; without a curve this is exactly rates_at(t)
            rates = self.sim.rates_at(t, t_sim=self.sim_time_s)
            # which devices start fresh work this round (fleet: up and not
            # carrying an in-flight gradient; legacy lockstep: everyone)
            if self.fleet is not None:
                avail = self.fleet.active_mask()
            else:
                avail = np.ones(cfg.n_devices, bool)
            # batch sizes + streaming waits
            waits_vec = np.zeros(cfg.n_devices)
            if cfg.weighted:
                batches = np.clip(rates, cfg.b_min, cfg.b_max) * avail
                wait = 0.0
            else:
                batches = np.full(cfg.n_devices, cfg.ddl_batch) * avail
                queues = np.array([b.size for b in self.buffers])
                if self.fleet is not None:
                    # per-device waits: the sync policy decides who is
                    # waited for (full-sync recovers the max over devices)
                    waits_vec = np.where(
                        avail, simclock.ddl_streaming_wait_per_device(
                            rates, queues, cfg.ddl_batch), 0.0)
                    wait = float(np.max(waits_vec)) if avail.any() else 0.0
                else:
                    wait = simclock.ddl_streaming_wait(rates, queues,
                                                       cfg.ddl_batch)
                    waits_vec[:] = wait
            # stream in: arrivals during the previous iteration (+ wait),
            # scaled by each device's uptime.  The batch is debited *before*
            # the fleet round decides the outcome; a crash or a policy
            # cancellation refunds it
            arriving = stream_lib.arrivals(
                rates, self.prev_iter_time + wait, self._online_frac)
            debited = np.zeros(cfg.n_devices)
            for i, b in enumerate(self.buffers):
                on_hand = b.size + float(arriving[i])
                b.step(float(arriving[i]), float(batches[i]))
                debited[i] = min(float(batches[i]), on_hand)
            if self._on_arrivals is not None:
                self._on_arrivals(arriving)
            # draw fixed-shape batches with masks
            if self._data_time_aware:
                xs, ys, masks = self.data.batches(self.rng, batches,
                                                  cfg.b_max,
                                                  t_sim=self.sim_time_s)
            else:
                xs, ys, masks = self.data.batches(self.rng, batches,
                                                  cfg.b_max)
            div = (np.asarray(self._div_fn(), np.float64)
                   if self._div_fn is not None else None)
            inj_bytes = 0
            if cfg.injection:
                alpha, beta = cfg.injection
                senders, n_share = inj_lib.injection_plan(
                    self.rng, cfg.n_devices, alpha, beta,
                    int(np.min(np.maximum(batches, 1))))
                xs, ys, inj_bytes = inj_lib.inject_batches(
                    self.rng, xs, ys, senders, n_share)
            self._mark("host")
            # the round's batch goes to the device once, here
            batch = (self._tensor(xs), self._tensor(ys, torch.int64),
                     self._tensor(masks))
            self._mark("upload")
            # compression decision from last EWMA state (host-level)
            use_comp = bool(self.compressor and
                            self.compressor.ewma.value <= self.compressor.delta
                            and self.compressor.ewma.initialized)
            if self.compressor:
                k_wire = self.compressor.k_for(self.n_floats)
                floats_wire = (2 * k_wire if use_comp else self.n_floats)
            else:
                floats_wire = self.n_floats
            # advance the clock: event-driven fleet round or legacy
            # lockstep.  The fleet round runs first because the realised
            # participant set masks aggregation.
            fleet_rec = {}
            if self.fleet is not None:
                # whether this round needs the snapshot-ring commit path is
                # derived from the policy it will run under (the policy is
                # live)
                use_carry = self._use_carry()
                if use_carry:
                    self._ring_push(self.fleet.version)
                res = self.fleet.round(waits=waits_vec, batches=batches,
                                       floats_on_wire=floats_wire,
                                       extra_bytes=inj_bytes, label_div=div)
                dt = res.dt
                # refund for thrown-away work: a crashed device or a
                # cancelled straggler loses its gradient, not its samples
                for i in set(res.crashed) | set(res.dropped):
                    if debited[i] > 0:
                        self.buffers[i].refund(debited[i])
                        debited[i] = 0.0
                if use_carry:
                    part, carry_args = self._plan_carry_commit(
                        res, batches, rates, batch, debited, use_comp, div)
                else:
                    part = res.part & (batches > 0)
                    carry_args = None
                self._online_frac = res.online_frac
                for i in res.interrupted:
                    if self.fleet.profiles[i].volatile_buffer:
                        self.buffers[i].clear()
                stale_vals = np.maximum(res.staleness, 0) * part
                pol = self.fleet.policy
                fleet_rec = {"n_started": float(res.started.sum()),
                             "n_part": float(part.sum()),
                             "n_dropped": float(len(res.dropped)),
                             "n_crashed": float(len(res.crashed)),
                             "n_carried": float(len(res.carried)),
                             "model_version": float(res.version),
                             "mean_stale": (float(stale_vals.sum())
                                            / max(float(part.sum()), 1.0)),
                             "max_stale": float(stale_vals.max(initial=0)),
                             "policy": pol.name,
                             **{f"knob_{k}": float(v)
                                for k, v in pol.knobs().items()}}
            else:
                part = avail
                carry_args = None
            used_fn = used_args = None    # the step function this round ran
            if carry_args is not None and not part.any():
                # nothing valid to aggregate at this commit: no update, and
                # carry the reported loss forward rather than a fake 0.0
                loss = (self.history[-1]["loss"] if self.history
                        else float("nan"))
                gap = 0.0
            else:
                if carry_args is not None:
                    step_fn, step_args = self._carry_step_fn, carry_args
                else:
                    agg_base = rates.astype(np.float64) if cfg.weighted \
                        else np.ones(cfg.n_devices)
                    if cfg.skew_weighting and div is not None:
                        agg_base = skew_corrected_rates(agg_base, div,
                                                        cfg.skew_floor)
                    agg_w = agg_base * part
                    rates_eff = rates * part
                    step_fn = self._step_fn
                    step_args = [self.params, self.momentum_state, *batch,
                                 self._tensor(rates_eff),
                                 self._tensor(agg_w), use_comp]
                self.params, self.momentum_state, loss, gap = \
                    step_fn(*step_args)
                used_fn, used_args = step_fn, step_args
                if self.compressor:
                    self.compressor.decide(float(gap))     # EWMA update
                    self.compressor.account(use_comp, self.n_floats)
            if self.fleet is None:
                dt = self.clock.step(wait_s=wait,
                                     local_batch=float(np.mean(batches)),
                                     floats_on_wire=floats_wire,
                                     extra_bytes=inj_bytes)
                wait_realised = wait
            else:
                # only committed fresh starters gated the barrier
                wait_realised = res.max_wait
            # close the control loop: the engine's controller (if any) sees
            # this commit's telemetry + realised loss
            if self.fleet is not None and self.fleet.controller is not None:
                action = self.fleet.controller_update(float(loss))
                if action is not None:
                    fleet_rec["ctrl_action"] = action.reason
            self.prev_iter_time = max(dt - wait_realised, 0.0)
            rec = {"step": t, "loss": float(loss),
                   "sim_time_s": self.sim_time_s,
                   "wait_s": wait, "global_batch": float(np.sum(batches)),
                   "buffer_total": float(sum(b.size for b in self.buffers)),
                   "gap": float(gap), "used_comp": float(use_comp),
                   "floats_wire": float(floats_wire),
                   "inj_bytes": float(inj_bytes), **fleet_rec}
            if div is not None:
                n_part = float(np.sum(part))
                rec["label_div_mean"] = (float(np.sum(div * part)) / n_part
                                         if n_part else 0.0)
                rec["label_div_max"] = (float(np.max(div * part))
                                        if n_part else 0.0)
            if eval_every and eval_fn and (t + 1) % eval_every == 0:
                rec.update(eval_fn(self.params))
            # observability: assemble + emit the round record only when a
            # tracker is listening (the noop path must cost nothing)
            if self._obs.active:
                # flop counting runs the step once more, on meta copies:
                # keep it out of the caller's phase marks
                hook, self.on_phase = self.on_phase, None
                try:
                    self._obs.on_round(
                        step=t, rec=rec, dt=dt,
                        step_fn=used_fn, step_args=used_args,
                        n_part=float(np.sum(part)),
                        floats_on_wire=floats_wire, inj_bytes=inj_bytes,
                        comm_model=(self.fleet.comm_model
                                    if self.fleet is not None else None))
                finally:
                    self.on_phase = hook
            self.history.append(rec)
        if self._obs.active:
            self._obs.on_run_end(self.summary())
        return self.history

    # live sync-policy control -----------------------------------------
    def set_sync_policy(self, policy, **knobs) -> None:
        """Queue a live sync-policy switch (family by name, or a ready
        policy instance); honoured at the next round boundary."""
        if self.fleet is None:
            raise ValueError("live sync-policy switching requires fleet mode "
                             "(ScaDLESConfig.fleet)")
        self.fleet.set_policy(policy, **knobs)

    def reconfigure_sync(self, **knobs) -> None:
        """Queue knob changes (e.g. ``semi_sync_k=4``) on the live policy."""
        if self.fleet is None:
            raise ValueError("live sync reconfiguration requires fleet mode "
                             "(ScaDLESConfig.fleet)")
        self.fleet.reconfigure(**knobs)

    @property
    def sim_time_s(self) -> float:
        return self.fleet.time_s if self.fleet is not None \
            else self.clock.time_s

    # summary metrics ---------------------------------------------------
    def summary(self) -> Dict[str, float]:
        out = {
            "sim_time_s": self.sim_time_s,
            "buffer_peak": float(sum(b.peak for b in self.buffers)),
            "buffer_final": float(sum(b.size for b in self.buffers)),
        }
        if self.compressor:
            out["cnc_ratio"] = self.compressor.cnc_ratio
            out["floats_sent"] = self.compressor.floats_sent * self.cfg.n_devices
        if self.fleet is not None:
            out.update(self.fleet.summary())
        return out

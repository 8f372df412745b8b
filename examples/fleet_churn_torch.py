"""Demo on the PyTorch port: training over a flaky edge fleet with device
churn.

The counterpart of ``examples/fleet_churn.py`` on ``repro_torch``, with its
flags, printed lines and budgets.  Runs ScaDLES (weighted aggregation +
truncation) on the ``phone-flaky`` profile — slow heterogeneous handsets on
thin links that drop out and rejoin mid-run, losing their stream buffers —
and prints a per-round timeline of the discrete-event engine
(participants, crashes, straggler drops), then compares full-sync against
the straggler-tolerant and relaxed-consistency policies (semi-sync K-batch
barriers, fully-async per-arrival commits) on simulated wall-clock, each
with a step budget sized to a comparable gradient count.  Two adaptive-sync
demos close it: a live policy switch (``ScaDLESTrainer.set_sync_policy``)
and the hill-climb controller (``FleetConfig(controller="hill-climb")``).

Run:  PYTHONPATH=src python examples/fleet_churn_torch.py
      PYTHONPATH=src python examples/fleet_churn_torch.py --track churn.jsonl
      PYTHONPATH=src python examples/fleet_churn_torch.py --device cpu

``--track`` attaches a ``repro_torch.obs.JsonTracker`` to every trainer in
the demo.  The trainers' tensors live on the CUDA card unless ``--device
cpu`` is given; the fleet engine and its sim clock are the host's.
"""
import argparse

import numpy as np

import torch

from repro_torch.core import TRUNCATION, ScaDLESConfig, ScaDLESTrainer
from repro_torch.data import ClassClusterData, DeviceDataSource
from repro_torch.fleet import FleetConfig
from repro_torch.models.mlp import make_mlp as make_model

N_DEVICES = 12
STEPS = 25

TRACKER = None   # set by --track: shared ledger for every run in the demo
DEVICE = "cuda"  # set by --device


def make_trainer(policy: str, **fleet_kw):
    data = ClassClusterData(num_classes=10, train_per_class=128,
                            test_per_class=32, noise=0.8, seed=0)
    model = make_model()
    src = DeviceDataSource(data, N_DEVICES, iid=True)
    tr = ScaDLESTrainer(model, src, ScaDLESConfig(
        n_devices=N_DEVICES, dist="S1", weighted=True, policy=TRUNCATION,
        b_max=128, grad_floats=60.2e6, seed=0, tracker=TRACKER,
        fleet=FleetConfig(profile="phone-flaky", policy=policy,
                          drop_frac=0.25, staleness_bound=4,
                          semi_sync_k=N_DEVICES // 3, churn=True,
                          **fleet_kw), device=DEVICE))
    return tr, model, data


def run(policy: str, steps: int = STEPS, verbose: bool = False):
    tr, model, data = make_trainer(policy)
    tr.run(steps)
    if verbose:
        print(f"\n== timeline ({policy}) ==")
        print(f"{'step':>4} {'sim_t':>8} {'loss':>7} {'started':>7} "
              f"{'part':>5} {'drop':>5} {'crash':>5}")
        for h in tr.history:
            print(f"{h['step']:>4} {h['sim_time_s']:>8.1f} {h['loss']:>7.3f} "
                  f"{int(h['n_started']):>7} {int(h['n_part']):>5} "
                  f"{int(h['n_dropped']):>5} {int(h['n_crashed']):>5}")
    return tr, accuracy(model, tr, data)


def accuracy(model, tr, data) -> float:
    logits = model["predict"](tr.params,
                              torch.as_tensor(data.test_x, device=tr.device))
    return float(np.mean(np.argmax(logits.cpu().numpy(), -1) == data.test_y))


def main(argv=None):
    global TRACKER, DEVICE
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--track", metavar="LEDGER",
                    help="append per-round + fleet-commit records to this "
                         "JSONL run ledger (stamped with git SHA + seed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    DEVICE = args.device
    if args.track:
        from repro_torch.obs import JsonTracker
        TRACKER = JsonTracker(args.track, seed=0,
                              meta={"entry": "examples.fleet_churn_torch",
                                    "n_devices": N_DEVICES})
    print(f"phone-flaky fleet, {N_DEVICES} devices, churn on")
    # relaxed policies commit fewer gradients per round: scale the step
    # budget so every policy commits a comparable number of gradients
    budgets = {"full-sync": STEPS, "backup-workers": STEPS,
               "bounded-staleness": STEPS, "semi-sync": 3 * STEPS,
               "async": N_DEVICES * STEPS // 2}
    results = {}
    for i, policy in enumerate(("full-sync", "backup-workers",
                                "bounded-staleness", "semi-sync", "async")):
        tr, acc = run(policy, steps=budgets[policy], verbose=(i == 0))
        s = tr.summary()
        # count gradients the trainer actually applied (n_part excludes
        # zero-weighted commits: idle-advance starters, evicted versions)
        grads = max(sum(h["n_part"] for h in tr.history), 1.0)
        results[policy] = (tr.sim_time_s / grads, acc)
        print(f"\n{policy:>18}: sim_time={tr.sim_time_s:8.1f}s  acc={acc:.3f}  "
              f"part_rate={s['fleet_part_rate']:.2f}  "
              f"crashes={int(s['fleet_crashed'])}  "
              f"dropped={int(s['fleet_dropped'])}  "
              f"stale(mean/max)={s['fleet_mean_staleness']:.1f}"
              f"/{int(s['fleet_max_staleness'])}")
    base = results["full-sync"][0]
    print("\nthroughput speedup vs full-sync (sim-s per committed gradient):")
    for policy, (t_per_grad, acc) in results.items():
        print(f"  {policy:>18}: {base / t_per_grad:5.2f}x  (acc {acc:.3f})")

    # -- live policy switch: one run, relaxing mid-flight ------------------
    # the switch is queued and honoured at the next round boundary; the
    # trainer re-derives carry machinery / ring sizing from the new policy
    print("\n== live switch: full-sync -> semi-sync(k=4) -> async ==")
    tr, model, data = make_trainer("full-sync")
    for policy, kw, steps in (("full-sync", {}, 8),
                              ("semi-sync", {"semi_sync_k": 4}, 16),
                              ("async", {}, 40)):
        if policy != "full-sync":
            tr.set_sync_policy(policy, **kw)
        tr.run(steps)
    for i, h in list(enumerate(tr.history))[::8]:
        print(f"  round {i:>3} ({h['policy']:>9}): "
              f"sim_t={h['sim_time_s']:7.1f}s loss={h['loss']:.3f} "
              f"part={int(h['n_part'])} stale={h['mean_stale']:.1f}")
    s = tr.summary()
    print(f"  switches={int(s['fleet_policy_switches'])}  "
          f"final sim_t={tr.sim_time_s:.1f}s")

    # -- controller: no policy guess at all --------------------------------
    print("\n== hill-climb controller (tunes k online) ==")
    tr, model, data = make_trainer("full-sync", controller="hill-climb")
    tr.run(N_DEVICES * STEPS // 2)
    ctrl = tr.fleet.controller
    acc = accuracy(model, tr, data)
    print(f"  settled on {tr.fleet.policy.name} (ref k={ctrl.ref_k})  "
          f"sim_time={tr.sim_time_s:.1f}s  acc={acc:.3f}")
    print(f"  decisions: {[a.reason for a in ctrl.actions]}")

    if TRACKER is not None:
        TRACKER.finish()
        print(f"\n# run ledger -> {args.track}")


if __name__ == "__main__":
    main()

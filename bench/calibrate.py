"""The readings that a cell's limits are set from, on the card at the
cell's own size; not part of the benchmark's runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds S] [--router]

Prints one JSON line a seed.  Training cells run no window: the program's
readings (its first three steps from the seed) against the reference's,
and on the control seeds the reference in TF32 (the control) and the
reference on half of each batch (a fault) against the reference.  The
serving cell runs its window of ``--seconds`` (the cell's own load) and,
on the control seeds, reads the TF32 reference over the same prompts and
served tokens.  With ``--router`` it also keeps the program's router
logits at every position it routed, and reads, for each request compared,
the widest gap between them and the reference's (over the positions before
the two first route a token differently), and reads each request set aside
for a near-tie again with the reference's near-ties routed the other way.
"""
import argparse
import copy
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--router", action="store_true")
    args = ap.parse_args()
    sys.path[0] = ROOT
    sys.path.insert(1, os.path.join(ROOT, "src"))
    import torch
    from bench import checks, harness
    from bench.drivers import train_ddp
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    torch.set_num_threads(4)
    bm, entry, wl, cfg = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    routed = _capture_routes() if args.router else None
    for seed in seeds + sorted(controls - set(seeds)):
        w = copy.deepcopy(wl)
        control = seed in controls
        if control and w["driver"] == "serve_closed":
            w["control"] = "tf32"
        spec = harness.Spec(cell=args.workload, wl=w, cfg=cfg, seed=seed,
                            seconds=args.seconds, trace=0, device=dev,
                            t_start=time.time(), log=lambda m: None)
        out = {"seed": seed}
        if routed is not None:
            routed.clear()
        if seed in seeds or w["driver"] == "serve_closed":
            rec = harness.load_module("drivers", w["driver"]).run(spec)
            out["program"] = rec["compared"]
            ref = rec["reference"]
            if w["driver"] == "serve_closed":
                out["reference"] = ref
            if routed is not None:
                out["router"] = _router_gaps(cfg, seed, rec, routed, dev)
        if control and w["driver"] == "train_ddp":
            if "program" not in out:
                ref = train_ddp.reference_readings(spec)
            out["control"] = checks.compare_train(
                train_ddp.reference_readings(spec, precision="tf32"), ref)
            out["half_batch"] = checks.compare_train(
                train_ddp.reference_readings(
                    spec, rows=slice(0, w["batch"] // 2)), ref)
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def _capture_routes():
    """Keep the program's router logits: {rid: {position: [per MoE layer
    (E,) f32 on the host]}}, filled as the serving loop runs."""
    import torch
    from repro_torch.models import decode, moe
    from repro_torch.serve.engine import SlotRunner
    routed, at = {}, {"rows": [], "layer": 0}
    route, step = moe._route, decode.ChunkedPrefill.step
    start, decode_step = SlotRunner.start_prefill, SlotRunner.step

    def start_prefill(self, req):
        at["rid"] = req.rid
        return start(self, req)

    def chunk(self, n):
        lo, hi = self.done_tokens, min(self.done_tokens + n, self.total)
        at.update(rows=[(at["rid"], p) for p in range(lo, hi)], layer=0)
        return step(self, n)

    def step_slots(self, active):
        rows = [None] * self.max_batch
        for s in active:
            rid = self._slot_rid[s]
            rows[s] = (rid, self.prompts[rid].shape[1]
                       + len(self.generated[rid]) - 1)
        at.update(rows=rows, layer=0)
        return decode_step(self, active)

    def capture(xg, router, cfg_moe, C):
        logits = torch.matmul(xg.float(), router.to(xg.dtype).float())
        flat = logits.reshape(-1, logits.shape[-1]).cpu()
        for row, key in zip(flat, at["rows"]):
            if key is not None:
                layers = routed.setdefault(key[0], {}).setdefault(key[1], [])
                if len(layers) == at["layer"]:
                    layers.append(row)
        at["layer"] += 1
        return route(xg, router, cfg_moe, C)

    SlotRunner.start_prefill = start_prefill
    decode.ChunkedPrefill.step = chunk
    SlotRunner.step = step_slots
    moe._route = capture
    return routed


def _router_gaps(cfg, seed, rec, routed, dev):
    """Per request compared: (P, n, the widest gap between the program's
    router logits and the reference's before the first position the two
    route differently, that position or None), and the witness's reading
    of the requests set aside."""
    import torch
    from bench import weights as W
    from bench.reference.model import Decoder
    from bench.reference.serve import token_gaps
    weights = W.make(cfg, seed, dev)
    ref = Decoder(cfg, weights)
    k = cfg["num_experts_per_tok"]
    rows = []
    with torch.no_grad():
        for rid, prompt, served, _ in rec["served"]:
            seq = torch.cat([prompt, served[:-1]]).to(dev)
            ref.hidden(seq[None])
            got = routed[rid]
            n_pos = seq.numel()
            prog = torch.stack([torch.stack(got[p]) for p in range(n_pos)],
                               dim=1).to(dev)               # (L, S, E)
            want = torch.stack(ref.router_logits)           # (L, S, E)
            same = (torch.topk(prog, k, dim=-1).indices.sort(-1).values
                    == torch.topk(want, k, dim=-1).indices.sort(-1).values
                    ).all(-1).all(0)                       # (S,)
            first = int((~same).nonzero()[0]) if not same.all() else None
            upto = n_pos if first is None else first
            gap = float((prog[:, :upto] - want[:, :upto]).abs().max()) \
                if upto else 0.0
            rows.append([prompt.numel(), served.numel(), gap, first])
        witness = token_gaps(cfg, weights, [
            (p.to(dev), s.to(dev), lg.to(dev))
            for _, p, s, lg in rec["served"]], witness=True)
    return {"requests": rows, "widest": max(r[2] for r in rows),
            "witness": witness["requests"]}


if __name__ == "__main__":
    main()

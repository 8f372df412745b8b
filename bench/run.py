"""Run one cell of the benchmark on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It needs a CUDA card (it exits with
code 2, printing no result, without one) and the port under
``src/repro_torch``.  Its last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``checks``: each number that decided
``correct`` beside its limit, which also end standard error.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch under {ROOT}: run from a checkout", 2)
    # caches at fixed places inside the checkout; no JAX through a library
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[0] = ROOT
    sys.path.insert(1, os.path.join(ROOT, "src"))

    import torch
    from bench import harness
    bm, entry, wl, cfg = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this benchmark runs on a "
             "CUDA card only", 2)
    if torch.cuda.device_count() < entry["chips"]:
        fail(f"{torch.cuda.device_count()} CUDA device(s); the cell asks "
             f"for {entry['chips']}", 2)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    print(f"bench: imports done {time.time() - T_START:.3f} s after start",
          file=sys.stderr, flush=True)
    spec = harness.Spec(cell=args.workload, wl=wl, cfg=cfg, seed=args.seed,
                        seconds=args.seconds, trace=args.trace,
                        device=torch.device("cuda", 0), t_start=T_START)
    result = harness.run_cell(bm, spec)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        fail(f"modules that the benchmark may not load are loaded: "
             f"{', '.join(loaded)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

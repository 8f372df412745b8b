"""Dry-run sweep: run every (arch x shape x mesh) as subprocesses.

    PYTHONPATH=src python -m repro_torch.launch.sweep --jobs 4 [--multi-pod] \
        [--archs a,b] [--shapes s1,s2] [--out artifacts/dryrun]

Counterpart of ``repro/launch/sweep.py``.  Each combination runs
``repro_torch.launch.dryrun`` in its own process (the fake process group
is process-wide, and a failed recording must not take down the sweep).
Results land as JSON artifacts; a failure leaves ``<tag>.err.txt``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = [
    "recurrentgemma-2b", "internlm2-20b", "mixtral-8x22b", "whisper-base",
    "qwen2-0.5b", "qwen1.5-0.5b", "qwen2-vl-2b", "xlstm-125m",
    "mistral-large-123b", "llama4-maverick-400b-a17b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def run_combo(arch: str, shape: str, multi_pod: bool, out: str,
              timeout: int = 3600):
    tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    path = os.path.join(out, tag + ".json")
    if os.path.exists(path):
        return tag, "cached", 0.0
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH="src")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=os.getcwd())
        dt = time.time() - t0
        if r.returncode == 0:
            return tag, "ok", dt
        err = (r.stderr or r.stdout).strip().splitlines()
        with open(os.path.join(out, tag + ".err.txt"), "w") as f:
            f.write(r.stderr + "\n" + r.stdout)
        return tag, "FAIL: " + (err[-1][:200] if err else "?"), dt
    except subprocess.TimeoutExpired:
        return tag, "TIMEOUT", time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    combos = [(a, s) for a in args.archs.split(",")
              for s in args.shapes.split(",")]
    os.makedirs(args.out, exist_ok=True)
    results = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = [ex.submit(run_combo, a, s, args.multi_pod, args.out,
                          args.timeout) for a, s in combos]
        for f in futs:
            tag, status, dt = f.result()
            print(f"{status:12s} {dt:7.1f}s {tag}", flush=True)
            results.append((tag, status, dt))
    n_ok = sum(1 for _, s, _ in results if s in ("ok", "cached"))
    print(f"\n{n_ok}/{len(results)} combinations recorded")
    if n_ok < len(results):
        sys.exit(1)


if __name__ == "__main__":
    main()

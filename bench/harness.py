"""Runs one cell: finds its files by name, drives it, reads its metrics and
builds the result line.

``load_cell`` reads ``BENCHMARK.json``, the cell's workload file and its
configuration file; ``run_cell`` hands them to the cell's driver
(``drivers/<driver>.py``: ``run(spec) -> record``) and reads each metric
the cell reports from the record with ``metrics/<metric>.py``
(``read(record) -> float or None``; None leaves the metric out).  With
``--trace 0`` those are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics.  ``run_cell`` makes no check of the device: the
entry point (``run.py``) does that.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List

from bench import checks as checks_lib

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell's entry, its workload file, its config)."""
    bm = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bm["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(BENCH / "workloads" / f"{name}.json")
    if wl["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file's config {wl['config']!r} "
                         f"against BENCHMARK.json's {entry['config']!r}")
    cfg = load_json(BENCH / "configs" / f"{entry['config']}.json")
    return bm, entry, wl, cfg


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bm: Dict, cell: str, trace: int) -> List[Dict]:
    """The metrics a cell reports: with trace 0 its end-to-end metrics (all
    cells, or those a metric's ``workloads`` lists), with trace 1 the
    per-layer metrics whose ``workloads`` list it."""
    if trace:
        return [m for m in bm["per_layer"] if cell in m["workloads"]]
    return [m for m in bm["end_to_end"]
            if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Spec:
    """What a driver gets: the cell's files, the run's arguments, and hooks
    a test may set to drive the run without the card."""
    cell: str
    wl: Dict
    cfg: Dict
    seed: int
    seconds: float
    trace: int
    device: Any
    t_start: float
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr,
                                                   flush=True)


def run_cell(bm: Dict, spec: Spec) -> Dict:
    driver = load_module("drivers", spec.wl["driver"])
    record = driver.run(spec)
    metrics = {}
    for m in metrics_for(bm, spec.cell, spec.trace):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = checks_lib.judged(record["compared"], spec.wl["limits"])
    device = {"platform": "gpu" if spec.device.type == "cuda" else "cpu",
              "kind": record["device_kind"], "count": 1,
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result: Dict[str, Any] = {
        "correct": checks_lib.passed(checks) and record["sound"],
        "attempted": int(record["attempted"]),
        "failed": int(record["failed"]),
        "metrics": metrics, "device": device}
    if spec.trace:
        prof = record["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    result["checks"] = checks
    return result

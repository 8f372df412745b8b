"""Perf-regression gate: diff fresh metrics against a blessed baseline.

The baseline (``BENCH_scadles.json`` at the repo root) is a committed map of
metric name -> :class:`MetricSpec`: the blessed value, a per-metric relative
tolerance band, and a direction saying which way is *worse*:

* ``higher``    — bigger is better (speedups, goodput, MFU): regression when
  ``current < value * (1 - tol_frac) - abs_tol``;
* ``lower``     — smaller is better (time-to-target, latency): regression
  when ``current > value * (1 + tol_frac) + abs_tol``;
* ``two-sided`` — the value is a *model constant* (wire bytes per round,
  step flops): any drift beyond the band is a regression, because silent
  change means the cost model changed.

:func:`compare` classifies every metric as ``pass`` / ``improved`` /
``regressed`` / ``missing_current`` (baseline metric the fresh run failed to
produce — a gate failure: losing a measurement is how claims rot) /
``new`` (fresh metric with no baseline — passes, bless to start gating it).
The :class:`GateReport` is machine-readable (CI artifact) and renders a
human table.

Carried over from ``repro/obs/regress.py`` unchanged (stdlib only).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.obs.tracker import SCHEMA_VERSION, JsonTracker, json_clean

HIGHER = "higher"
LOWER = "lower"
TWO_SIDED = "two-sided"
_DIRECTIONS = (HIGHER, LOWER, TWO_SIDED)

PASS = "pass"
IMPROVED = "improved"
REGRESSED = "regressed"
MISSING_CURRENT = "missing_current"
NEW = "new"


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One blessed metric: value + tolerance band + worse-direction."""
    value: float
    tol_frac: float = 0.10
    direction: str = HIGHER
    abs_tol: float = 0.0
    note: str = ""

    def __post_init__(self) -> None:
        if self.direction not in _DIRECTIONS:
            raise ValueError(f"direction {self.direction!r} not in "
                             f"{_DIRECTIONS}")
        if self.tol_frac < 0 or self.abs_tol < 0:
            raise ValueError("tolerances must be non-negative")

    # -- band edges ------------------------------------------------------
    def worst_allowed(self) -> float:
        """The band edge on the *worse* side (two-sided: the lower edge)."""
        slack = abs(self.value) * self.tol_frac + self.abs_tol
        return self.value + slack if self.direction == LOWER \
            else self.value - slack

    def classify(self, current: Optional[float]) -> str:
        if current is None:
            return MISSING_CURRENT
        slack = abs(self.value) * self.tol_frac + self.abs_tol
        if self.direction == HIGHER:
            if current < self.value - slack:
                return REGRESSED
            return IMPROVED if current > self.value + slack else PASS
        if self.direction == LOWER:
            if current > self.value + slack:
                return REGRESSED
            return IMPROVED if current < self.value - slack else PASS
        # two-sided: drift either way is a regression
        return PASS if abs(current - self.value) <= slack else REGRESSED

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if not self.note:
            d.pop("note")
        if self.abs_tol == 0.0:
            d.pop("abs_tol")
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "MetricSpec":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass
class GateReport:
    """Machine-readable verdict of one baseline comparison."""
    rows: Dict[str, Dict[str, Any]]

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def failures(self) -> Dict[str, Dict[str, Any]]:
        return {k: r for k, r in self.rows.items()
                if r["status"] in (REGRESSED, MISSING_CURRENT)}

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in (PASS, IMPROVED, REGRESSED, MISSING_CURRENT,
                              NEW)}
        for r in self.rows.values():
            out[r["status"]] += 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "counts": self.counts(),
                "rows": json_clean(self.rows)}

    def format_table(self) -> str:
        lines = [f"{'metric':<38} {'baseline':>12} {'current':>12} "
                 f"{'worst ok':>12}  status"]
        for name in sorted(self.rows):
            r = self.rows[name]

            def _f(v):
                return f"{v:>12.4g}" if isinstance(v, (int, float)) \
                    and v is not None else f"{'-':>12}"
            lines.append(f"{name:<38} {_f(r.get('baseline'))} "
                         f"{_f(r.get('current'))} {_f(r.get('worst_allowed'))}"
                         f"  {r['status'].upper()}")
        c = self.counts()
        lines.append(f"=> {'PASS' if self.ok else 'FAIL'}  "
                     + "  ".join(f"{k}={v}" for k, v in c.items() if v))
        return "\n".join(lines)


def compare(baseline: Mapping[str, MetricSpec],
            current: Mapping[str, Optional[float]]) -> GateReport:
    """Classify every metric in baseline ∪ current against the bands."""
    rows: Dict[str, Dict[str, Any]] = {}
    for name, spec in baseline.items():
        cur = current.get(name)
        cur = float(cur) if cur is not None else None
        rows[name] = {
            "status": spec.classify(cur),
            "baseline": spec.value,
            "current": cur,
            "worst_allowed": spec.worst_allowed(),
            "tol_frac": spec.tol_frac,
            "direction": spec.direction,
        }
    for name, cur in current.items():
        if name not in baseline and cur is not None:
            rows[name] = {"status": NEW, "baseline": None,
                          "current": float(cur), "worst_allowed": None,
                          "tol_frac": None, "direction": None}
    return GateReport(rows)


# ---------------------------------------------------------------------------
# baseline (de)serialisation


def load_baseline(path: str) -> Tuple[Dict[str, Any], Dict[str, MetricSpec]]:
    """Read a blessed baseline file -> (meta, name -> MetricSpec)."""
    with open(path) as f:
        doc = json.load(f)
    if "metrics" not in doc:
        raise ValueError(f"{path} is not a perf baseline (no 'metrics' key)")
    specs = {name: MetricSpec.from_dict(d)
             for name, d in doc["metrics"].items()}
    meta = {k: v for k, v in doc.items() if k != "metrics"}
    return meta, specs


def save_baseline(path: str, specs: Mapping[str, MetricSpec], *,
                  seed: Optional[int] = None,
                  meta: Optional[Mapping] = None) -> None:
    """Bless a baseline: stamped like every other artifact (git SHA, seed,
    schema version) so a committed number is traceable to the code that
    produced it."""
    JsonTracker.write_artifact(
        path,
        {"baseline_schema": SCHEMA_VERSION,
         "metrics": {name: spec.to_dict()
                     for name, spec in sorted(specs.items())}},
        seed=seed, meta=meta)


def write_report(path: str, report: GateReport, *,
                 baseline_path: str, meta: Optional[Mapping] = None) -> None:
    """Machine-readable gate report (the CI artifact)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    JsonTracker.write_artifact(
        path, {"baseline": baseline_path, **report.to_dict()}, meta=meta)

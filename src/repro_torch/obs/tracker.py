"""Run trackers: the sink side of the observability subsystem.

Carried over from ``repro/obs/tracker.py`` unchanged (numpy and stdlib
only).

Every speed claim in this repo is a number in a JSON artifact; trackers are
how those numbers get written the same way everywhere.  The split follows
levanter's ``callbacks.py``/``tracker/`` design: producers (trainer rounds,
fleet commits, serve events) call a tiny ``Tracker`` interface and never
know where the records land.

* :class:`JsonTracker`   — append-only JSONL run ledger.  Every run opens
  with a ``run_start`` header stamped with the git SHA, seed, config hash
  and schema version, so a ledger line is attributable to an exact code +
  config state months later.
* :class:`CompositeTracker` — fan-out to several sinks.
* :class:`MemoryTracker` — in-process record list (tests, controllers).
* :class:`NoopTracker`   — ``active = False``; producers gate all metric
  assembly on ``tracker.active``, so observability-off costs nothing on any
  hot path (the zero-perturbation invariant: a tracked run stays bit-exact
  with an untracked one).

``JsonTracker.write_artifact`` is the single-JSON flavour used by
``benchmarks/common.write_json_artifact`` — one stamping path for ledgers
and benchmark artifacts alike.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import time
from functools import lru_cache
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

SCHEMA_VERSION = 1

# config fields that are attachments, not configuration: they must not
# perturb the config hash (a tracked run hashes identically to an untracked
# one) and are unserialisable anyway
_UNHASHED_FIELDS = ("tracker",)


@lru_cache(maxsize=1)
def git_sha() -> str:
    """Current git commit SHA, or "unknown" outside a work tree.

    ``SCADLES_GIT_SHA`` overrides (hermetic CI containers without .git).
    """
    env = os.environ.get("SCADLES_GIT_SHA")
    if env:
        return env
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except Exception:
        pass
    return "unknown"


def _canon(v: Any) -> Any:
    """Canonical JSON-able rendering of a config value for hashing."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _canon(getattr(v, f.name))
                for f in dataclasses.fields(v)
                if f.name not in _UNHASHED_FIELDS}
    if isinstance(v, Mapping):
        return {str(k): _canon(x)
                for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return repr(v)


def config_hash(cfg: Any) -> str:
    """Stable short hash of a config (dataclass / dict / anything)."""
    blob = json.dumps(_canon(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def json_clean(v: Any) -> Any:
    """Strict-JSON rendering: numpy scalars/arrays unwrap, non-finite floats
    become null (never-reached targets, undefined speedups), unknown objects
    degrade to their repr — anywhere in the payload."""
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, np.ndarray):
        return [json_clean(x) for x in v.tolist()]
    if isinstance(v, Mapping):
        return {str(k): json_clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_clean(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "item") and getattr(v, "shape", None) == ():
        return json_clean(v.item())          # 0-d array (numpy, torch)
    return repr(v)


def run_stamp(*, seed: Optional[int] = None, config: Any = None,
              extra: Optional[Mapping] = None) -> Dict[str, Any]:
    """The provenance header every ledger and artifact carries."""
    stamp: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "git_sha": git_sha(),
        "seed": seed,
        "time_unix": time.time(),
    }
    if config is not None:
        stamp["config_hash"] = config_hash(config)
    if extra:
        stamp.update(json_clean(dict(extra)))
    return stamp


# ---------------------------------------------------------------------------
# trackers


class Tracker:
    """Minimal sink interface the producers program against.

    ``active`` is the hot-path gate: producers must skip metric *assembly*
    entirely when it is False, so a noop tracker costs nothing.
    """

    active: bool = True

    def log_metrics(self, metrics: Mapping, *, step: Optional[int] = None,
                    kind: str = "metrics") -> None:
        raise NotImplementedError

    def log_summary(self, summary: Mapping, *, kind: str = "summary") -> None:
        self.log_metrics(summary, kind=kind)

    def finish(self) -> None:
        pass

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class NoopTracker(Tracker):
    """Observability off: every call is a pass, ``active`` is False."""

    active = False

    def log_metrics(self, metrics: Mapping, *, step: Optional[int] = None,
                    kind: str = "metrics") -> None:
        pass


#: shared inert instance — producers default to this, never to None
NOOP = NoopTracker()


class MemoryTracker(Tracker):
    """Record list in process memory (tests, ad-hoc inspection)."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.finished = False

    def log_metrics(self, metrics: Mapping, *, step: Optional[int] = None,
                    kind: str = "metrics") -> None:
        self.records.append({"kind": kind, "step": step,
                             "data": json_clean(dict(metrics))})

    def finish(self) -> None:
        self.finished = True

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]


class CompositeTracker(Tracker):
    """Fan one producer stream out to several sinks."""

    def __init__(self, trackers: Sequence[Tracker]) -> None:
        self.trackers = list(trackers)

    @property
    def active(self) -> bool:  # type: ignore[override]
        return any(t.active for t in self.trackers)

    def log_metrics(self, metrics: Mapping, *, step: Optional[int] = None,
                    kind: str = "metrics") -> None:
        for t in self.trackers:
            if t.active:
                t.log_metrics(metrics, step=step, kind=kind)

    def log_summary(self, summary: Mapping, *, kind: str = "summary") -> None:
        for t in self.trackers:
            if t.active:
                t.log_summary(summary, kind=kind)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


class JsonTracker(Tracker):
    """Append-only JSONL run ledger.

    One line per record; the first line of every run is a ``run_start``
    header carrying the provenance stamp (git SHA, seed, config hash,
    schema version).  ``finish()`` appends a ``run_end`` marker.  Records
    are flushed per write so a crashed run still leaves a readable ledger.
    """

    def __init__(self, path: str, *, seed: Optional[int] = None,
                 config: Any = None, meta: Optional[Mapping] = None,
                 mode: str = "a") -> None:
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, mode)
        self._closed = False
        self._write({"kind": "run_start",
                     **run_stamp(seed=seed, config=config, extra=meta)})

    def _write(self, record: Mapping) -> None:
        if self._closed:
            raise ValueError(f"ledger {self.path} is finished")
        self._fh.write(json.dumps(json_clean(dict(record))) + "\n")
        self._fh.flush()

    def log_metrics(self, metrics: Mapping, *, step: Optional[int] = None,
                    kind: str = "metrics") -> None:
        self._write({"kind": kind, "step": step, "data": dict(metrics)})

    def finish(self) -> None:
        if not self._closed:
            self._write({"kind": "run_end", "time_unix": time.time()})
            self._closed = True
            self._fh.close()

    # -- single-JSON artifacts -------------------------------------------
    @classmethod
    def write_artifact(cls, path: str, payload: Mapping, *,
                       seed: Optional[int] = None, config: Any = None,
                       meta: Optional[Mapping] = None) -> Dict[str, Any]:
        """Write one benchmark payload as a stamped strict-JSON artifact.

        The payload gains a ``"run"`` key with the same provenance stamp a
        ledger header carries — this is the one artifact-writing path for
        every ``benchmarks/*.py`` module.  Returns the written dict.
        """
        out = json_clean(dict(payload))
        out["run"] = json_clean(run_stamp(seed=seed, config=config,
                                          extra=meta))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return out


def read_ledger(path: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse a JSONL ledger back into records, optionally one kind only."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out


def ledger_metrics(records: Iterable[Mapping], kind: str,
                   key: str) -> List[float]:
    """Pull one metric's trajectory out of parsed ledger records."""
    vals = []
    for r in records:
        if r.get("kind") == kind and key in r.get("data", {}):
            v = r["data"][key]
            if v is not None:
                vals.append(float(v))
    return vals

"""Calibrate the fleet engine's comm model against the recorded DDP programs.

Counterpart of ``repro/dist/calibrate.py``.  The fleet engine charges
communication from the analytic ring formula ``2(N-1)/N * 4 *
floats_on_wire``.  This module replaces that estimate with the collective
wire bytes of the two DDP programs in ``repro_torch.train.ddp`` (dense
weighted all-reduce vs all-gather of packed top-k): each program is run
once for the fleet's device count on a fake process group and fake CPU
tensors (``dist/hlo_cost.py::record``), and the per-device collective wire
bytes it issued become a :class:`CommCalibration` that plugs into
``FleetConfig.comm_model``.  The legacy analytic model stays the default:
``comm_model=None`` keeps the homogeneous full-sync case bit-exact with
``EdgeClock``, so calibration is strictly opt-in.

The default process group belongs to the whole process, so
:func:`calibrate` runs the recording in a subprocess, as the reference
lowers in one, and caches the result as a JSON artifact under
``artifacts/perf/`` with the reference's file names.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Optional


def ring_wire_bytes(n_devices: int, floats_on_wire: float) -> float:
    """The legacy analytic model: per-device ring all-reduce bytes."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * 4.0 * floats_on_wire


@dataclasses.dataclass(frozen=True)
class CommCalibration:
    """Per-round, per-device collective wire bytes of the two DDP programs.

    ``bytes_for`` is the fleet engine's comm-bytes source: the trainer
    announces ``floats_on_wire`` (``n_floats`` dense, ``2k`` compressed) and
    the calibration returns the measured bytes of the matching program.
    Float counts near the dense size scale the dense program, counts near
    ``2k`` scale the compressed one (other cr values) — a calibration is
    per-model, so simulate a different model with its own calibration, not
    by scaling this one.
    """
    n_devices: int
    n_floats: int
    k: int
    dense_wire_bytes: float
    compressed_wire_bytes: float
    arch: str = ""
    source: str = "hlo"

    def bytes_for(self, floats_on_wire: float) -> float:
        comp_floats = 2.0 * self.k
        if 2.0 * floats_on_wire >= self.n_floats + comp_floats:
            return self.dense_wire_bytes * floats_on_wire / self.n_floats
        return self.compressed_wire_bytes * floats_on_wire / comp_floats

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CommCalibration":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass(frozen=True)
class AnalyticRingModel:
    """Calibration-shaped wrapper around the legacy formula (useful for A/B
    runs: an engine given this model matches the default engine exactly)."""
    n_devices: int

    def bytes_for(self, floats_on_wire: float) -> float:
        return ring_wire_bytes(self.n_devices, floats_on_wire)


# ---------------------------------------------------------------------------
# recording + extraction

_CALIB_SCRIPT = r"""
import json
import torch
from repro_torch.configs import get_config
from repro_torch.dist.hlo_cost import (analyze, fake_cpu, fake_mode,
                                       fake_world, record)
from repro_torch.models.transformer import RunCtx, init_params
from repro_torch.optim.optimizers import sgdm_init, sgdm_update
from repro_torch.train.ddp import make_ddp_steps

cfg = get_config(%(arch)r)
if %(reduced)r:
    cfg = cfg.reduced()
ctx = RunCtx(remat=%(remat)r, chunk_q=%(chunk)d, chunk_k=%(chunk)d,
             loss_chunk=%(chunk)d, device="cpu")
template = init_params(None, cfg, device="meta")
opt_update = lambda g, s, p, lr: sgdm_update(g, s, p, lr=lr, momentum=0.9)
dense_step, comp_step, k, n_floats = make_ddp_steps(
    cfg, ctx, opt_update, lambda t: 1e-3, cr=%(cr)r,
    param_template=template)
out = {"n_devices": %(n)d, "k": k, "n_floats": n_floats, "arch": %(arch)r}
with fake_world(%(n)d):
    mode = fake_mode()
    params = fake_cpu(template, mode)
    opt = fake_cpu(sgdm_init(template), mode)
    with mode:
        batch = {"tokens": torch.zeros((%(batch)d, %(seq)d), dtype=torch.int32),
                 "labels": torch.zeros((%(batch)d, %(seq)d), dtype=torch.int32)}
        rates = torch.ones((%(n)d,), dtype=torch.float32)
        step = torch.zeros((), dtype=torch.int32)
    for name, fn in (("dense", dense_step), ("compressed", comp_step)):
        program = record(fn, params, opt, batch, rates, step)
        out[name + "_wire_bytes"] = analyze(program)["collective_bytes"]
print(json.dumps(out))
"""


def _cache_path(arch: str, n_devices: int, cr: float, reduced: bool,
                cache_dir: str) -> str:
    tag = f"comm_calibration__{arch.replace('/', '_')}__d{n_devices}__cr{cr}"
    if reduced:
        tag += "__reduced"
    return os.path.join(cache_dir, tag + ".json")


def calibrate(arch: str = "qwen1.5-0.5b", n_devices: int = 8,
              cr: float = 0.1, *, reduced: bool = True,
              batch_per_device: int = 2, seq_len: int = 64,
              remat: bool = False, cache_dir: str = "artifacts/perf",
              timeout: int = 1800,
              repo_root: Optional[str] = None) -> CommCalibration:
    """Record the two DDP programs for ``n_devices`` and return their
    per-device collective wire bytes as a :class:`CommCalibration`.

    Runs in a subprocess (the fake process group is process-wide) and
    caches the JSON artifact, so repeat calls are free.  ``reduced=True``
    (the default) records the smoke-scale config — the wire *ratio* is
    size-independent, and calibrating the full model is a dry-run-scale
    job, not a test-scale one.  No device is used: the programs run on
    fake CPU tensors.
    """
    path = _cache_path(arch, n_devices, cr, reduced, cache_dir)
    if os.path.exists(path):
        with open(path) as f:
            return CommCalibration.from_dict(json.load(f))
    script = _CALIB_SCRIPT % {
        "n": n_devices, "arch": arch, "reduced": reduced, "cr": cr,
        "batch": batch_per_device * n_devices, "seq": seq_len,
        "remat": remat, "chunk": min(seq_len, 512),
    }
    env = dict(os.environ)
    root = repo_root or os.getcwd()
    src = os.path.join(root, "src")
    env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else src)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=root)
    if r.returncode != 0:
        tail = (r.stderr or r.stdout).strip().splitlines()[-5:]
        raise RuntimeError("calibration recording failed:\n"
                           + "\n".join(tail))
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    cal = CommCalibration(
        n_devices=rec["n_devices"], n_floats=rec["n_floats"], k=rec["k"],
        dense_wire_bytes=rec["dense_wire_bytes"],
        compressed_wire_bytes=rec["compressed_wire_bytes"], arch=rec["arch"])
    os.makedirs(cache_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cal.to_dict(), f, indent=1)
    return cal


def calibrated_fleet_config(fleet_cfg, arch: str = "qwen1.5-0.5b",
                            cr: float = 0.1, n_devices: Optional[int] = None,
                            **kwargs):
    """Return a copy of ``FleetConfig`` with ``comm_model`` set from a
    (cached) calibration for the fleet's device count."""
    n = n_devices if n_devices is not None else 8
    cal = calibrate(arch, n, cr, **kwargs)
    return dataclasses.replace(fleet_cfg, comm_model=cal)

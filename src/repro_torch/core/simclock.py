"""Simulated edge clock: wall-time model for speedup comparisons.

The paper reports wall-clock speedups on dockerised K80s + 5 Gbps ethernet; we
run on CPU, so convergence comparisons use this calibrated clock:

    iter_time = streaming_wait + compute_time + comm_time

* streaming_wait — conventional DDL waits for the slowest device to gather a
  full mini-batch: max_i (deficit_i / S_i); ScaDLES trains on whatever
  streamed in the last interval, so its wait is 0 (the 1 s stream interval is
  absorbed by compute/comm overlap, matching the paper's per-iteration model).
* compute_time — calibrated per-model seconds/iter at reference batch 64
  (paper Table II: ResNet152 1.2 s, VGG19 1.6 s on a K80), scaled linearly in
  the actual local batch.
* comm_time — bytes_on_wire / bandwidth; an allreduce of G fp32 grads moves
  2 (N-1)/N * 4G bytes per device (ring), compression scales it by the
  effective ratio; data-injection broadcast bytes are added on top.

Carried over from ``repro/core/simclock.py`` with its logic unchanged, so
the port's sim times equal the reference's to the last bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def effective_bandwidth_Bps(bandwidth_gbps: float,
                            bandwidth_efficiency: float) -> float:
    """Effective link rate in bytes/s: line rate scaled by the calibrated
    allreduce efficiency.  The single source of the Gbps->B/s conversion —
    the clock, the fleet engine's per-link model, and any future calibration
    must all agree on it."""
    return bandwidth_gbps * 1e9 / 8 * bandwidth_efficiency


@dataclasses.dataclass
class EdgeClockConfig:
    bandwidth_gbps: float = 5.0
    # effective fraction of line rate achieved by allreduce over the docker
    # swarm overlay: calibrated so gradient sync takes ~80-90% of a ResNet152
    # iteration as the paper measures (Fig 4a) — raw 5 Gbps would give ~10%
    bandwidth_efficiency: float = 0.18
    compute_sec_per_iter: float = 1.2     # at reference batch
    reference_batch: int = 64
    n_devices: int = 16
    grad_floats: float = 60.2e6           # model size (ResNet152 default)

    @property
    def effective_bw_Bps(self) -> float:
        return effective_bandwidth_Bps(self.bandwidth_gbps,
                                       self.bandwidth_efficiency)


@dataclasses.dataclass
class EdgeClock:
    cfg: EdgeClockConfig
    time_s: float = 0.0

    def comm_time(self, floats_on_wire: float) -> float:
        n = self.cfg.n_devices
        ring = 2 * (n - 1) / n
        bytes_ = ring * 4.0 * floats_on_wire
        return bytes_ / self.cfg.effective_bw_Bps

    def compute_time(self, local_batch: float) -> float:
        return (self.cfg.compute_sec_per_iter
                * max(local_batch, 1) / self.cfg.reference_batch)

    def step(self, *, wait_s: float, local_batch: float,
             floats_on_wire: float, extra_bytes: float = 0.0) -> float:
        # injection broadcast bytes ride the same overlay as the allreduce, so
        # they see the same effective (efficiency-scaled) bandwidth
        dt = (wait_s + self.compute_time(local_batch)
              + self.comm_time(floats_on_wire)
              + extra_bytes / self.cfg.effective_bw_Bps)
        self.time_s += dt
        return dt


def ddl_streaming_wait_per_device(rates: np.ndarray, queues: np.ndarray,
                                  batch: int) -> np.ndarray:
    """Seconds each device needs to gather ``batch`` samples (the fleet
    engine schedules these independently; lockstep takes the max)."""
    deficit = np.maximum(batch - queues, 0.0)
    return deficit / np.maximum(rates, 1e-9)


def ddl_streaming_wait(rates: np.ndarray, queues: np.ndarray,
                       batch: int) -> float:
    """Wait until the slowest device has gathered ``batch`` samples."""
    return float(np.max(ddl_streaming_wait_per_device(rates, queues, batch)))

"""Collective traffic of a recorded program + the three-term roofline.

Counterpart of ``repro/dist/hlo_analysis.py``.  ``CollectiveOp`` captures
one collective: its kind, the bytes the wire factor applies to (the full
tensor for all-reduce, the gathered output for all-gather, the output
shard for reduce-scatter, the output for all-to-all) and the participant
group's size.  ``wire_bytes`` converts that to per-device bytes on the
wire under the standard ring algorithms:

    all-reduce      2 (D-1)/D * bytes      (reduce-scatter + all-gather)
    all-gather        (D-1)/D * bytes      (bytes = full gathered tensor)
    reduce-scatter    (D-1)   * bytes      (bytes = the output shard)
    all-to-all        (D-1)/D * bytes
    collective-permute         bytes       (each device forwards its block)

``roofline`` combines counted flops, bytes accessed and collective wire
bytes into per-device seconds against one NVIDIA H100 SXM and names the
bottleneck.  The reference's constants are a TPU v5e's; these are the
H100's published peaks from NVIDIA's data sheet, at its 700 W limit
(dense rates, no sparsity), not measurements: 989 TFLOP/s bf16 (the
reference's choice of a bf16 peak: the dry run places bf16 params),
3.35 TB/s of HBM, and NVLink 4's 900 GB/s both ways, so 450 GB/s each
way, which is what a ring sends per device.  The same three terms drive
``launch/dryrun.py``'s artifacts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# one NVIDIA H100 SXM (data sheet, 700 W); roofline terms are *relative*
# rankings, so the exact part only matters for absolute seconds
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s per card
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth per card
ICI_BYTES_PER_S = 450e9    # NVLink 4 per card, one direction

_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective-permute")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective as recorded: (kind, bytes, group size)."""
    kind: str
    bytes: float
    group_size: int

    @property
    def wire_bytes(self) -> float:
        d = max(int(self.group_size), 1)
        if d <= 1:
            return 0.0
        if self.kind.startswith("all-reduce"):
            return 2.0 * (d - 1) / d * self.bytes
        if self.kind.startswith("all-gather") or self.kind.startswith("all-to-all"):
            return (d - 1) / d * self.bytes
        if self.kind.startswith("reduce-scatter"):
            return (d - 1) * self.bytes
        if self.kind.startswith("collective-permute"):
            return self.bytes
        return self.bytes


def collective_bytes(program) -> Dict[str, float]:
    """Per-kind wire-byte breakdown of every collective ``program`` ran
    (a :class:`repro_torch.dist.hlo_cost.Program`).

    The reference counts each ``while`` body once here and attaches the
    trip-count-aware total as ``total_looped``.  The port's program is the
    sequence of ops it executed, so every executed collective is counted:
    the two views coincide, and ``launch/dryrun.py`` writes both keys.
    """
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_KINDS}
    count = 0
    for op in program.ops:
        if op.collective is None:
            continue
        out[op.collective.kind] += op.collective.wire_bytes
        count += 1
    out["count"] = float(count)
    out["total"] = sum(out[k] for k in _COLLECTIVE_KINDS)
    return out


def roofline(flops: float, bytes_accessed: float,
             wire_bytes: float) -> Dict[str, object]:
    """Three-term per-device time model: compute vs HBM vs interconnect."""
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_accessed / HBM_BYTES_PER_S,
        "collective_s": wire_bytes / ICI_BYTES_PER_S,
    }
    bottleneck = max(terms, key=terms.get)[: -len("_s")]
    return dict(terms, bottleneck=bottleneck, step_s=max(terms.values()))


def model_flops(n_active_params: int, tokens: float, mode: str) -> float:
    """Reference MODEL_FLOPS: 6ND for train (fwd+bwd), 2ND forward-only."""
    per_token = 6.0 if mode == "train" else 2.0
    return per_token * float(n_active_params) * float(tokens)

"""Rates, percentiles and spreads: the arithmetic of the end-to-end metrics,
kept here so that it does not move when the program does."""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of ``values`` by linear interpolation between
    the closest ranks (numpy's default): rank (n - 1) q / 100."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def window_gaps(times: Dict[int, List[float]], t0: float,
                t1: float) -> List[float]:
    """Every gap between consecutive tokens of one request, both emitted
    inside the window (t0, t1]: ``times`` maps a request to the host times
    at which its tokens arrived."""
    out = []
    for ts in times.values():
        inside = [t for t in ts if t0 < t <= t1]
        out += [b - a for a, b in zip(inside, inside[1:])]
    return out


def window_count(times: Dict[int, List[float]], t0: float, t1: float) -> int:
    """Tokens that arrived inside the window (t0, t1]."""
    return sum(1 for ts in times.values() for t in ts if t0 < t <= t1)


def union_length(intervals: Iterable[Sequence[float]]) -> float:
    """The length covered by the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total

"""Reductions from per-event records and device intervals to numbers."""
from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile over all ``values``: the smallest
    value with at least p % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[rank - 1]


def union_length(intervals, lo: float, hi: float) -> float:
    """Total length of the union of ``(start, end)`` intervals clipped to
    [lo, hi]: time in which at least one of them ran."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles``' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

"""The statistics of the end-to-end metrics: rates over a whole window and
percentiles over every request."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) of ``values`` by linear interpolation
    between the closest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(total: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return total / seconds


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``): how a bound is sized."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

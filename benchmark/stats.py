"""The arithmetic of the end-to-end metrics and of their spread."""
from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 <= q <= 100) by linear interpolation
    between the closest ranks: rank q/100 (n - 1) of the sorted values."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = q / 100.0 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work completed per second of wall time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, the quartiles as ``statistics.quantiles(values, n=4)``
    gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)

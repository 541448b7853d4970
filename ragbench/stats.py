"""The arithmetic of the end-to-end metrics and of run-to-run spread."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank: the smallest value
    with at least q% of the values at or below it.  ``inf`` counts as a
    value (a request that never finished is infinitely late)."""
    vals = sorted(values)
    if not vals:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def latencies_ms(due, done) -> list[float]:
    """Per request, done minus due in ms; a request with no completion time
    (None) is infinitely late."""
    return [math.inf if d is None else (d - s) * 1e3 for s, d in zip(due, done)]


def completed_rate(done, start: float, end: float) -> float:
    """Requests completed inside [start, end] over its length."""
    n = sum(1 for d in done if d is not None and start <= d <= end)
    return n / (end - start)


def spread(values) -> float:
    """Interquartile distance over the median (Python's default quartile
    method), the measure a bound is set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else math.inf

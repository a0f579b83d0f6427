"""Whole-window statistics: rates over all the work and all the time of
a window, tails over all its requests, and the spread the bounds are
set from."""

from __future__ import annotations

import statistics
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    """Units completed per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile of every value (``statistics.quantiles``,
    inclusive method, so a stall among the values counts)."""
    if not values:
        raise ValueError("a percentile of no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median,
    as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

"""The rate of the end-to-end metrics, and the spread that sets a bound
(the quartiles of Python's ``statistics.quantiles``)."""

from __future__ import annotations

import statistics
from typing import Sequence


def rate(units: float, start: float, end: float) -> float:
    """Work over the whole span from the first unit's start to the last
    unit's end."""
    return units / (end - start)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

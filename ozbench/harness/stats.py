"""Statistics of a measured window."""

from __future__ import annotations

import math
from typing import Sequence


def rate(units: int, work_per_unit: float, seconds: float) -> float:
    """All the work completed in the window over all of its time."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return units * work_per_unit / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile of every value: the smallest value
    that at least q % of them do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]

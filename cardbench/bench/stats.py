"""Order statistics of the benchmark: a percentile over every request (a
missing one counts as infinitely late) and medians."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it.  ``inf`` stands
    for a request that never answered, and wins the tail."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def median(values: Sequence[float]) -> Optional[float]:
    """The median, or None for no values."""
    return statistics.median(values) if values else None

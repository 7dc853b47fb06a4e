"""Order statistics as the metrics define them."""

from __future__ import annotations

import math

__all__ = ["nearest_rank", "MISSING"]

MISSING = math.inf      # a request that never produced what was timed ranks above all


def nearest_rank(values, q: float) -> float:
    """The ``q``-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least ``q`` of all values at or below it.  ``MISSING`` values
    count and rank above every other value."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(math.ceil(q * len(vals)) - 1, 0)]

"""Percentiles."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(samples: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by the nearest-rank rule: the
    smallest sample with at least q% of the samples at or below it."""
    ordered = sorted(samples)
    if not ordered:
        raise ValueError("no samples")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


"""Tails and spreads, taken over every sample."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile of all ``values`` (numpy's linear rule), or
    None when there are none."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, the quartiles as ``statistics.quantiles(values, n=4)`` gives
    them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else float("inf")

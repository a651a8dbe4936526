"""Statistics of a window: tails, rates and spreads.

* ``p95`` is the 95th percentile of every sample, by linear interpolation
  between the closest ranks (numpy's default), never a mean of pieces.
* ``window_rate`` is the work over the seconds from the window's start to
  the end of its last operation: a closed loop starts no operation after the
  window's length has passed, and the one that runs across the end counts
  whole, with its time.
* ``spread`` is the distance between the first and the third quartile as
  ``statistics.quantiles(values, n=4)`` gives them, over the median.
"""

from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def p95(samples: Sequence[float]) -> float:
    if len(samples) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), 95.0))


def window_rate(work: float, start: float, last_end: float) -> float:
    """``work`` units done between ``start`` and ``last_end`` (seconds)."""
    if last_end <= start:
        raise ValueError("the window has no length")
    return work / (last_end - start)


def spread(values: Sequence[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)

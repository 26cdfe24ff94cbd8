"""Percentiles, copied (not imported) from the program's
``serving/metrics.py:percentile`` so that a change to the program cannot
change the yardstick."""
from __future__ import annotations

import numpy as np


def percentile(xs, p: float) -> float | None:
    """numpy's linear-interpolation percentile; None on no samples."""
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), p))


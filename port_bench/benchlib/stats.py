"""Order statistics (the arithmetic of the port's
``core/telemetry.percentile``)."""
from __future__ import annotations

from typing import Sequence


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an unsorted sample."""
    if not samples:
        return float("nan")
    xs = sorted(samples)
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac

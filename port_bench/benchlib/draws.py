"""Seeded draws shared by the traffic generators (the arithmetic of the
port's ``harness/trace.py``: clipped lognormal lengths, Zipf
popularity)."""
from __future__ import annotations

import numpy as np


def lognormal(rng, spec: dict, n: int) -> np.ndarray:
    """``n`` lognormal draws with median ``spec["median"]`` and shape
    ``spec["sigma"]``, clipped to ``[min, max]`` and made whole."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def zipf_ranks(rng, count: int, s: float, n: int) -> np.ndarray:
    """``n`` ranks in ``[0, count)``, rank r drawn with weight
    (r + 1)^-s."""
    w = np.arange(1, count + 1, dtype=np.float64) ** -float(s)
    return rng.choice(count, size=n, p=w / w.sum())

"""Step-level fault tolerance, as ``repro.distributed.fault_tolerance``:
the ``StragglerMonitor`` the trainer times its steps with.
``FailureDetector`` and ``plan_elastic_mesh`` come with the mesh
(ROADMAP Queue A item 13)."""
from __future__ import annotations

from typing import List


class StragglerMonitor:
    """Detects slow steps: a step is a straggler when it takes more than
    ``threshold`` times the median of the last ``window`` steps (at least
    5 of them)."""

    def __init__(self, window: int = 20, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.durations: List[float] = []

    def record(self, seconds: float) -> bool:
        """Returns True if this step was a straggler."""
        self.durations.append(seconds)
        hist = self.durations[-self.window - 1: -1]
        if len(hist) < 5:
            return False
        median = sorted(hist)[len(hist) // 2]
        return seconds > self.threshold * median

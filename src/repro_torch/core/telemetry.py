"""Structured dispatch telemetry — the paper's CPU%/RAM/time tables.

A pure-Python copy of the part of ``repro.core.telemetry`` that the
serving engine records into: one ``DispatchSample`` per finished request
into ``DispatchStats``, summarised as percentiles (p50/p95/p99 wall, cold
vs warm split, per-class footprints) for ``launch/serve.py``, plus named
annotation blocks (the speculation counters).  The JSON view and the
windowed, per-service, per-tenant and per-replica views come with the
control-plane and fleet slices that read them (ROADMAP Queue A items 9
and 10).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Sequence

PERCENTILES = (50.0, 95.0, 99.0)


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile over an unsorted sample list."""
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


@dataclasses.dataclass(frozen=True)
class DispatchSample:
    workload: str
    workload_class: str            # "heavy" | "light"
    executor_class: str            # "container" | "unikernel"
    executor: str
    node: str
    wall_s: float
    cold: bool                     # deployed/compiled fresh on this dispatch
    footprint_bytes: int
    winner: str = "primary"        # "primary" | "backup"
    backup_launched: bool = False


class DispatchStats:
    """Thread-safe sample sink with percentile summaries."""

    def __init__(self):
        self._lock = threading.Lock()
        self.samples: List[DispatchSample] = []
        # named annotation blocks (the engine's speculation counters);
        # the latest value of each wins
        self._extra: Dict[str, object] = {}

    def record(self, sample: DispatchSample) -> None:
        with self._lock:
            self.samples.append(sample)

    def set_extra(self, key: str, value: object) -> None:
        """Attach or refresh a named annotation block."""
        with self._lock:
            self._extra[key] = value

    def extras(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._extra)

    def __len__(self) -> int:
        with self._lock:
            return len(self.samples)

    # ------------------------------------------------------------------
    @staticmethod
    def summarize(samples: Sequence[DispatchSample]) -> Dict[str, float]:
        if not samples:
            return {}
        walls = [s.wall_s for s in samples]
        cold = [s for s in samples if s.cold]
        warm = [s for s in samples if not s.cold]
        out = {
            "count": len(samples),
            "mean_wall_s": sum(walls) / len(walls),
            "mean_footprint_bytes": sum(s.footprint_bytes for s in samples)
            / len(samples),
            "cold_count": len(cold),
            "warm_count": len(warm),
        }
        for q in PERCENTILES:
            out[f"p{q:g}_wall_s"] = percentile(walls, q)
        if cold:
            out["cold_mean_wall_s"] = sum(s.wall_s for s in cold) / len(cold)
        if warm:
            out["warm_mean_wall_s"] = sum(s.wall_s for s in warm) / len(warm)
        return out

    def summary(self) -> Dict[str, object]:
        with self._lock:
            samples = list(self.samples)
        per_class = {
            wc: self.summarize([s for s in samples
                                if s.workload_class == wc])
            for wc in ("heavy", "light")
        }
        per_executor = {}
        for ec in ("container", "unikernel"):
            sub = [s for s in samples if s.executor_class == ec]
            if sub:
                per_executor[ec] = {
                    "count": len(sub),
                    "mean_footprint_bytes":
                        sum(s.footprint_bytes for s in sub) / len(sub),
                }
        backups = [s for s in samples if s.backup_launched]
        return {
            **per_class,
            "executors": per_executor,
            "backups": {
                "launched": len(backups),
                "wins": sum(1 for s in backups if s.winner == "backup"),
            },
        }

"""Structured dispatch telemetry — the paper's CPU%/RAM/time tables.

``DispatchStats`` replaces the manager's old free-form record lists with a
typed sample stream and percentile summaries (p50/p95/p99 wall, cold vs
warm split, per-class footprints).  The benchmarks and ``launch/serve.py``
consume the same summaries the manager's ``report()`` exposes, so every
layer reports latency the same way.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

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
    service: str = ""              # owning ServiceSpec name ("" = ad-hoc)
    tenant: str = ""               # owning spec's tenant ("" = unattributed)
    replica: str = ""              # serving instance ("svc/0"; "" = unknown)


class DispatchStats:
    """Thread-safe sample sink with percentile summaries."""

    def __init__(self):
        self._lock = threading.Lock()
        self.samples: List[DispatchSample] = []
        # free-form per-subsystem annotations (e.g. the serving engine's
        # speculation counters) — latest value wins, serialized alongside
        # the sample summaries so scorecards/fig7 carry them for free
        self._extra: Dict[str, object] = {}

    def record(self, sample: DispatchSample) -> None:
        with self._lock:
            self.samples.append(sample)

    def set_extra(self, key: str, value: object) -> None:
        """Attach (or refresh) a named annotation block, e.g.
        ``set_extra("speculation", {...acceptance counters...})``."""
        with self._lock:
            self._extra[key] = value

    def extras(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._extra)

    def __len__(self) -> int:
        with self._lock:
            return len(self.samples)

    def samples_for(self, service: Optional[str] = None,
                    tenant: Optional[str] = None) -> List[DispatchSample]:
        """Snapshot of samples filtered by service and/or tenant."""
        with self._lock:
            return [s for s in self.samples
                    if (service is None or s.service == service)
                    and (tenant is None or s.tenant == tenant)]

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
        return self._summary_of(samples)

    def windowed(self, window: int = 256) -> Dict[str, object]:
        """``summary()`` over only the most recent ``window`` samples —
        the live view scorecards and dashboards want (all-time summaries
        let a cold-start tail dominate a long-running server)."""
        with self._lock:
            samples = self.samples[-window:] if window > 0 else []
        return self._summary_of(samples)

    @classmethod
    def _summary_of(cls, samples: Sequence[DispatchSample]
                    ) -> Dict[str, object]:
        per_class = {
            wc: cls.summarize([s for s in samples
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

    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        """Latency summary split by tenant — the QoS fairness report the
        fig7 benchmark and ``EdgeSystem.report`` surface."""
        with self._lock:
            samples = list(self.samples)
        tenants = sorted({s.tenant for s in samples if s.tenant})
        return {t: self.summarize([s for s in samples if s.tenant == t])
                for t in tenants}

    def per_replica(self) -> Dict[str, Dict[str, float]]:
        """Latency summary split by serving replica — lets fig7 and the
        fleet scorecards attribute a p95 to the instance that caused it
        instead of blending the fleet."""
        with self._lock:
            samples = list(self.samples)
        replicas = sorted({s.replica for s in samples if s.replica})
        return {r: self.summarize([s for s in samples if s.replica == r])
                for r in replicas}

    def to_dict(self, window: Optional[int] = None) -> Dict[str, object]:
        """JSON-ready view: the stable ``summary()`` shape (or a windowed
        one), per-tenant and per-replica splits, and the total sample
        count."""
        out = {
            "version": 1,
            "total_samples": len(self),
            "window": window,
            "summary": self.summary() if window is None
            else self.windowed(window),
            "per_tenant": self.per_tenant(),
            "per_replica": self.per_replica(),
        }
        extras = self.extras()
        if extras:
            out["extra"] = extras
        return out

    def to_json(self, window: Optional[int] = None,
                indent: Optional[int] = None) -> str:
        """Serialized telemetry for scorecards / ``BENCH_*.json`` files."""
        import json
        return json.dumps(self.to_dict(window), sort_keys=True,
                          indent=indent)

    # ------------------------------------------------------------------
    @classmethod
    def from_walls(cls, name: str, walls: Sequence[float],
                   workload_class: str = "heavy",
                   executor_class: str = "container",
                   footprint_bytes: int = 0,
                   executor: str = "", node: str = "") -> "DispatchStats":
        """Adapter for benchmark loops that already collected wall times."""
        stats = cls()
        for w in walls:
            stats.record(DispatchSample(
                workload=name, workload_class=workload_class,
                executor_class=executor_class, executor=executor, node=node,
                wall_s=w, cold=False, footprint_bytes=footprint_bytes))
        return stats

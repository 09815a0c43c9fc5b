"""Open-loop trace replay against a live ``EdgeSystem``; the port of
``repro.harness.replay``.

The replayer fires arrivals on the wall clock (``offset_s / speed`` after
start) regardless of whether earlier requests have completed — open-loop,
so a slow system accumulates queueing instead of silently throttling the
workload (the closed-loop coordination-omission trap).  Each arrival is
dispatched on a worker thread through ``EdgeSystem.submit``, which routes
to the event's applied service, charges its tenant through the admission
controller, and records a ``DispatchSample``.

Per-request results land in ``RequestOutcome``: the scheduled vs actual
dispatch instant (open-loop lag), end-to-end latency measured from the
*scheduled* arrival (queueing is part of the number), engine queue time
when the service is engine-backed, the admission outcome (ok / refused /
failed), and whether a GUARANTEED request had to be requeued.  Chaos
actions (``harness.chaos``) merge into the same timeline; orchestrator
events observed during the window (preempt / requeue / failover /
redeploy) ride along on the report for the scorecard.

GUARANTEED semantics: a refusal or failure is retried
(``requeue_attempts``) after a short backoff — the replay-level analogue
of the engine's evicted-instance requeue — so the scorecard can assert
"completed or requeued, never silently dropped".
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import FIRST_EXCEPTION  # noqa: F401 (re-export)
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.admission import AdmissionError
from repro_torch.core.spec import QoSClass, ServiceSpec
from repro_torch.core.workload import Workload, WorkloadKind
from repro_torch.harness.chaos import ChaosInjector, ChaosRecord
from repro_torch.harness.trace import Trace, TraceEvent

MakeItem = Callable[[TraceEvent], Tuple[Workload, Tuple]]


def default_make_item(ev: TraceEvent) -> Tuple[Workload, Tuple]:
    """(Workload, args) for sim-backed services: heavy/container routing,
    name-prefix ``<service>-<eid>`` for per-service attribution, args
    carrying the token counts the ``SimExecutor`` prices."""
    w = Workload(f"{ev.service}-{ev.eid}", WorkloadKind.GENERIC,
                 seq_len=ev.output_len, est_flops=1e10,
                 latency_slo_ms=ev.latency_slo_ms)
    return w, (ev.prompt_len, ev.output_len)


def specs_for_trace(trace: Trace, replicas: int = 2,
                    footprint_hint: int = 8 << 20) -> List[ServiceSpec]:
    """Reconstruct the service specs a trace expects from its
    ``meta["services"]`` header (tenant, QoS, SLO per service)."""
    specs = []
    for name, d in sorted(trace.meta.get("services", {}).items()):
        specs.append(ServiceSpec(
            name=name,
            workload=Workload(name, WorkloadKind.GENERIC, est_flops=1e10),
            replicas=replicas, footprint_hint=footprint_hint,
            latency_slo_ms=d.get("latency_slo_ms", 0.0),
            tenant=d.get("tenant", "default"),
            qos=QoSClass(d.get("qos", "burstable")),
            priority=d.get("priority", 0)))
    return specs


@dataclasses.dataclass
class RequestOutcome:
    eid: int
    service: str
    tenant: str
    qos: str
    offset_s: float                 # scheduled arrival (trace time)
    lag_s: float                    # open-loop dispatch skew (wall)
    latency_s: float                # scheduled arrival → completion (wall)
    service_s: float                # dispatch wall inside the system
    queue_s: float                  # engine queue time (0 when unknown)
    status: str                     # ok | refused | failed | timeout
    requeues: int = 0               # GUARANTEED retry count
    slo_ms: float = 0.0
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def slo_met(self) -> bool:
        """Within SLO; SLO-less requests count as met when completed."""
        if not self.ok:
            return False
        return self.slo_ms <= 0 or self.latency_s <= self.slo_ms / 1e3

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("offset_s", "lag_s", "latency_s", "service_s", "queue_s"):
            d[k] = round(d[k], 6) if math.isfinite(d[k]) else None
        return d


@dataclasses.dataclass
class ReplayReport:
    trace_name: str
    seed: int
    duration_s: float               # trace time
    speed: float
    wall_s: float                   # observed replay wall
    outcomes: List[RequestOutcome]
    events: List[str]               # orchestrator events during the window
    chaos: List[ChaosRecord]

    def counts(self) -> Dict[str, int]:
        out = {"total": len(self.outcomes), "completed": 0, "refused": 0,
               "failed": 0, "timeout": 0, "requeued": 0}
        for o in self.outcomes:
            if o.ok:
                out["completed"] += 1
            else:
                out[o.status] = out.get(o.status, 0) + 1
            if o.requeues:
                out["requeued"] += 1
        return out


class TraceReplayer:
    """Drives one trace (plus an optional chaos script) to completion."""

    def __init__(self, system, trace: Trace,
                 make_item: Optional[MakeItem] = None, speed: float = 1.0,
                 chaos: Optional[ChaosInjector] = None,
                 max_workers: int = 32, requeue_attempts: int = 2,
                 requeue_delay_s: float = 0.05,
                 drain_timeout_s: float = 60.0,
                 submit_fn=None):
        if speed <= 0:
            raise ValueError("speed must be positive")
        self.system = system
        self.trace = trace
        self.make_item = make_item or default_make_item
        # alternate data plane: ``submit_fn(workload, args)`` replaces
        # ``system.submit`` (the fleet replay routes through a
        # ``FleetRouter`` instead of the manager's dispatch path) — it
        # must return a DispatchResult-shaped object (``.output``,
        # ``.wall_s``) and may raise ``AdmissionError`` for refusals
        self.submit_fn = submit_fn
        self.speed = speed
        self.chaos = chaos
        self.max_workers = max_workers
        self.requeue_attempts = requeue_attempts
        self.requeue_delay_s = requeue_delay_s
        self.drain_timeout_s = drain_timeout_s
        self._outcomes: List[RequestOutcome] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def run(self) -> ReplayReport:
        timeline: List[Tuple[float, int, object]] = [
            (ev.offset_s, 1, ev) for ev in self.trace.events]
        if self.chaos is not None:
            # chaos scheduled at the same instant as an arrival fires
            # first — the arrival must observe the fault, not race it
            timeline += [(a.at_s, 0, a) for a in self.chaos.pending()]
        timeline.sort(key=lambda x: (x[0], x[1]))
        events_base = len(self.system.events)
        futures: Dict[Future, TraceEvent] = {}
        t0 = time.monotonic()
        with ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="trace-replay") as pool:
            for at_s, kind, item in timeline:
                delay = t0 + at_s / self.speed - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                rel = (time.monotonic() - t0) * self.speed
                if kind == 0:
                    self.chaos.fire(item, rel)
                else:
                    futures[pool.submit(self._one, item, t0)] = item
            done, not_done = wait(futures, timeout=self.drain_timeout_s)
            for fut in not_done:
                ev = futures[fut]
                self._record(RequestOutcome(
                    eid=ev.eid, service=ev.service, tenant=ev.tenant,
                    qos=ev.qos, offset_s=ev.offset_s, lag_s=float("nan"),
                    latency_s=float("inf"), service_s=float("nan"),
                    queue_s=0.0, status="timeout", slo_ms=ev.latency_slo_ms,
                    error=f"no completion within {self.drain_timeout_s}s"))
            if not_done:          # don't block shutdown on stuck dispatches
                pool.shutdown(wait=False, cancel_futures=True)
        if self.chaos is not None:
            self.chaos.join()
        wall = time.monotonic() - t0
        with self._lock:
            outcomes = sorted(self._outcomes, key=lambda o: o.eid)
        return ReplayReport(
            trace_name=self.trace.name, seed=self.trace.seed,
            duration_s=self.trace.duration_s, speed=self.speed,
            wall_s=wall, outcomes=outcomes,
            events=list(self.system.events)[events_base:],
            chaos=list(self.chaos.records) if self.chaos else [])

    # ------------------------------------------------------------------
    def _record(self, outcome: RequestOutcome):
        with self._lock:
            self._outcomes.append(outcome)

    def _one(self, ev: TraceEvent, t0: float):
        scheduled = ev.offset_s / self.speed
        lag = (time.monotonic() - t0) - scheduled
        workload, args = self.make_item(ev)
        slo_ms = workload.latency_slo_ms or ev.latency_slo_ms
        attempts = 1
        if ev.qos_class is QoSClass.GUARANTEED:
            attempts += self.requeue_attempts
        status, err, res, requeues = "failed", "", None, 0
        for i in range(attempts):
            try:
                submit = self.submit_fn or self.system.submit
                res = submit(workload, args)
                status = "ok"
                break
            except AdmissionError as e:
                status, err = "refused", str(e)
            except Exception as e:  # noqa: BLE001 — placement/dispatch
                status, err = "failed", str(e)
            if i + 1 < attempts:
                requeues += 1
                time.sleep(self.requeue_delay_s)
        finished = time.monotonic() - t0
        queue_s = 0.0
        if res is not None:
            out = res.output
            admitted = getattr(out, "admitted_at", None)
            submitted = getattr(out, "submitted_at", None)
            if admitted is not None and submitted is not None:
                queue_s = max(0.0, admitted - submitted)
        self._record(RequestOutcome(
            eid=ev.eid, service=ev.service, tenant=ev.tenant, qos=ev.qos,
            offset_s=ev.offset_s, lag_s=lag,
            latency_s=(finished - scheduled) if status == "ok"
            else float("inf"),
            service_s=res.wall_s if res is not None else float("nan"),
            queue_s=queue_s, status=status, requeues=requeues,
            slo_ms=slo_ms, error=err))

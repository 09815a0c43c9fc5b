"""Scripted mid-replay fault injection; the port of
``repro.harness.chaos``.

A ``ChaosAction`` names a fault and a trace-relative firing time; the
replayer merges actions into the arrival timeline and calls
``ChaosInjector.fire`` at the right wall-clock instant.  Supported kinds:

* ``node-loss`` / ``node-rejoin`` — drive the orchestrator's failure
  path (``EdgeSystem.on_node_loss`` / ``on_node_rejoin``) and record the
  recovery: instances moved, failovers that found no capacity, and the
  wall seconds the redeploy took (time-to-redeploy).
* ``engine-stall`` — freeze a service's executors for ``duration_s``
  (trace time; the injector scales by replay speed).  Engine-backed
  deployments stall by holding the engine lock — submissions and ticks
  genuinely block, like a hung accelerator; ``SimExecutor`` stalls
  cooperatively via its ``stall()`` hook.
* ``quota-set`` / ``quota-clear`` — tenant-quota churn through the
  admission controller, the knob that turns refusals on mid-replay.

Every firing returns a ``ChaosRecord`` the scorecard serializes, so a
scenario's fault script and its measured recovery live next to the SLO
numbers.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

KINDS = ("node-loss", "node-rejoin", "engine-stall", "quota-set",
         "quota-clear")


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    at_s: float                        # trace-relative firing time
    kind: str
    target: str = ""                   # node id / service / tenant
    duration_s: float = 0.0            # engine-stall only (trace time)
    hbm_bytes: Optional[int] = None    # quota-set
    flops_inflight: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"one of {KINDS}")

    def to_dict(self) -> dict:
        return {"at_s": self.at_s, "kind": self.kind, "target": self.target,
                "duration_s": self.duration_s, "hbm_bytes": self.hbm_bytes,
                "flops_inflight": self.flops_inflight}


@dataclasses.dataclass
class ChaosRecord:
    kind: str
    target: str
    at_s: float                        # scripted trace time
    fired_at_s: float                  # observed trace time
    wall_s: float                      # time the fault handler itself took
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "target": self.target,
                "at_s": round(self.at_s, 6),
                "fired_at_s": round(self.fired_at_s, 6),
                "wall_s": round(self.wall_s, 6), "details": self.details}


class ChaosInjector:
    """Executes a fault script against a live ``EdgeSystem``."""

    def __init__(self, system, actions: List[ChaosAction],
                 speed: float = 1.0):
        self.system = system
        self.speed = speed
        self.actions = sorted(actions, key=lambda a: a.at_s)
        self.records: List[ChaosRecord] = []
        self._stall_threads: List[threading.Thread] = []

    def pending(self) -> List[ChaosAction]:
        return list(self.actions)

    # ------------------------------------------------------------------
    def fire(self, action: ChaosAction, rel_s: float) -> ChaosRecord:
        t0 = time.monotonic()
        details: Dict[str, Any] = {}
        try:
            details = self._dispatch(action)
        except Exception as e:  # noqa: BLE001 — a broken fault script must
            # not kill the replay; the record carries the error instead
            details = {"error": str(e)}
        rec = ChaosRecord(kind=action.kind, target=action.target,
                          at_s=action.at_s, fired_at_s=rel_s,
                          wall_s=time.monotonic() - t0, details=details)
        self.records.append(rec)
        return rec

    def _dispatch(self, action: ChaosAction) -> Dict[str, Any]:
        if action.kind == "node-loss":
            before = len(self.system.events)
            moved = self.system.on_node_loss(action.target)
            new = self.system.events[before:]
            return {"moved": len(moved),
                    "failover_failed": sum(
                        1 for e in new if e.startswith("failover-FAILED"))}
        if action.kind == "node-rejoin":
            healed = self.system.on_node_rejoin(action.target)
            return {"healed": len(healed)}
        if action.kind == "engine-stall":
            return self._stall_service(action.target,
                                       action.duration_s / self.speed)
        if action.kind == "quota-set":
            self.system.set_tenant_quota(
                action.target, hbm_bytes=action.hbm_bytes,
                flops_inflight=action.flops_inflight)
            return {"hbm_bytes": action.hbm_bytes,
                    "flops_inflight": action.flops_inflight}
        if action.kind == "quota-clear":
            self.system.admission.set_quota(action.target, None)
            return {}
        raise ValueError(action.kind)       # unreachable: validated on init

    def _stall_service(self, target: str, wall_s: float) -> Dict[str, Any]:
        """Freeze every executor of a service — or ONE replica when
        ``target`` names a single instance (``"svc/0"``), the fleet
        scenario: one engine wedges, the router must route around it."""
        deps = self.system.instances(target)
        if not deps:
            dep = self.system.orchestrator.deployments.get(target)
            deps = [dep] if dep is not None else []
        stalled = []
        for dep in deps:
            engine = getattr(dep.executor, "engine", None)
            if engine is not None and hasattr(engine, "_lock"):
                t = threading.Thread(
                    target=self._hold_lock, args=(engine._lock, wall_s),
                    name=f"chaos-stall-{dep.name}", daemon=True)
                t.start()
                self._stall_threads.append(t)
                stalled.append(dep.name)
            elif hasattr(dep.executor, "stall"):
                dep.executor.stall(wall_s)
                stalled.append(dep.name)
        return {"stalled": len(stalled), "instances": stalled,
                "wall_s": wall_s}

    @staticmethod
    def _hold_lock(lock, wall_s: float):
        # sleeping under the engine lock is the entire point of the
        # engine-stall fault: it freezes the loop for wall_s so recovery
        # behavior is measurable (baselined BL001, not a defect)
        with lock:
            time.sleep(wall_s)

    def join(self, timeout: float = 10.0):
        """Wait out any in-flight engine stalls (end-of-replay hygiene)."""
        for t in self._stall_threads:
            t.join(timeout)

"""Fault tolerance, as ``repro.distributed.fault_tolerance``: the
``StragglerMonitor`` the trainer times its steps with, and the heartbeat
``FailureDetector`` whose health changes the orchestrator and
``EdgeSystem`` act on (a host missing heartbeats → its serving instances
are redeployed on healthy nodes).  ``plan_elastic_mesh`` comes with the
mesh (ROADMAP Queue A item 13)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence


@dataclasses.dataclass
class HostState:
    host_id: str
    last_heartbeat: float
    healthy: bool = True
    incarnation: int = 0          # bumps when a host rejoins


class FailureDetector:
    """Phi-accrual-lite: a host is failed after ``timeout`` without beats."""

    def __init__(self, hosts: Sequence[str], timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.hosts: Dict[str, HostState] = {
            h: HostState(h, now) for h in hosts}
        self._listeners: List[Callable[[str, bool], None]] = []

    def on_change(self, fn: Callable[[str, bool], None]):
        self._listeners.append(fn)

    def heartbeat(self, host_id: str):
        st = self.hosts[host_id]
        st.last_heartbeat = self.clock()
        if not st.healthy:
            st.healthy = True
            st.incarnation += 1
            for fn in self._listeners:
                fn(host_id, True)

    def poll(self) -> List[str]:
        """Returns hosts newly marked failed."""
        now = self.clock()
        newly_failed = []
        for st in self.hosts.values():
            if st.healthy and now - st.last_heartbeat > self.timeout:
                st.healthy = False
                newly_failed.append(st.host_id)
                for fn in self._listeners:
                    fn(st.host_id, False)
        return newly_failed

    def healthy_hosts(self) -> List[str]:
        return [h for h, st in self.hosts.items() if st.healthy]



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

"""Fault tolerance, as ``repro.distributed.fault_tolerance``: the
``StragglerMonitor`` the trainer times its steps with, and the heartbeat
``FailureDetector`` whose health changes the orchestrator and
``EdgeSystem`` act on (a host missing heartbeats → its serving instances
are redeployed on healthy nodes), and ``plan_elastic_mesh``: after host
failures, the shrunk mesh a trainer restarts on from its last checkpoint
(``checkpointing.restore`` places the leaves onto any mesh)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple


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


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """What to do after failures: the new mesh shape + batch scaling."""
    data_axis: int
    model_axis: int
    pods: int
    global_batch_scale: float     # keep per-replica batch, shrink global
    note: str


def plan_elastic_mesh(total_hosts: int, failed_hosts: int,
                      chips_per_host: int = 4,
                      base_mesh: Tuple[int, int] = (16, 16),
                      pods: int = 1) -> ElasticPlan:
    """Shrink the data axis by whole host groups; never break the model
    axis.  A host failure removes whole data-parallel rows; the plan keeps
    the model axis and shrinks data parallelism to the largest power of
    two at most the surviving rows (gradient reduction groups stay
    regular), folding whole pods back in where the rows fill them."""
    data, model = base_mesh
    chips_total = total_hosts * chips_per_host
    assert data * model * pods == chips_total, (base_mesh, pods, chips_total)
    rows_per_host = max(1, data * pods // max(total_hosts, 1))
    surviving_rows = data * pods - failed_hosts * rows_per_host
    if surviving_rows <= 0:
        raise RuntimeError("no surviving data-parallel rows")
    new_rows = 1 << (surviving_rows.bit_length() - 1)   # pow2 floor
    new_pods = 1
    new_data = new_rows
    if pods > 1 and new_rows % data == 0:
        new_pods = new_rows // data
        new_data = data
    return ElasticPlan(
        data_axis=new_data, model_axis=model, pods=new_pods,
        global_batch_scale=new_rows / (data * pods),
        note=(f"{failed_hosts} host(s) failed → data axis "
              f"{data * pods}→{new_rows} rows (pow2 floor), model axis kept"))


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

"""Deterministic simulated services for harness replays; the port of
``repro.harness.sim``.

A ``SimExecutor`` stands in for a real model server: service time is an
affine function of prompt/output length (wall-clock ``time.sleep``, so
replay latencies are real concurrency measurements, just cheap ones), it
routes by workload-name prefix (``<service>-<eid>``) so every tenant's
traffic lands on — and is attributed to — that tenant's own applied
``ServiceSpec``, and it supports a cooperative ``stall()`` the chaos
injector uses for services that aren't engine-backed.

Benchmarks use this to replay full multi-minute trace mixes in seconds;
the real-engine path (``EngineExecutor``) plugs into the same replayer
unchanged.
"""
from __future__ import annotations

import threading
import time

from repro_torch.core.executor import (BaseExecutor, DispatchRecord,
                                       ExecutorClass)
from repro_torch.core.workload import Workload


class SimExecutor(BaseExecutor):
    """Container-class stand-in with deterministic service time."""

    executor_class = ExecutorClass.CONTAINER

    def __init__(self, name: str, prefix: str, mesh=None,
                 base_s: float = 2e-4, per_token_s: float = 2e-6,
                 footprint: int = 8 << 20):
        super().__init__(name, mesh)
        self.prefix = prefix
        self.base_s = base_s
        self.per_token_s = per_token_s
        self._footprint = footprint
        self._stall_until = 0.0
        self._stall_lock = threading.Lock()
        # one request served at a time — a replica has unit capacity, so
        # bursts above service rate queue (real latency under load)
        self._serve_lock = threading.Lock()
        self.dispatch_order: list = []     # shared order sink (tests)

    def footprint_bytes(self) -> int:
        return self._footprint

    def can_run(self, workload: Workload, args) -> bool:
        return workload.name.startswith(self.prefix + "-")

    # ------------------------------------------------------------- chaos
    def stall(self, wall_s: float) -> None:
        """Freeze the executor: dispatches entering during the stall wait
        it out (an engine hang / cold restart analogue)."""
        with self._stall_lock:
            self._stall_until = max(self._stall_until,
                                    time.monotonic() + wall_s)

    # ---------------------------------------------------------- dispatch
    def dispatch(self, workload: Workload, args):
        self.inflight += 1
        t0 = time.monotonic()
        try:
            # sleeping inside _serve_lock models a unit-capacity server:
            # concurrent dispatches queue behind the sleep, which is what
            # makes sim latency numbers meaningful (baselined BL001)
            with self._serve_lock:
                with self._stall_lock:
                    wait = self._stall_until - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                plen, olen = (int(args[0]), int(args[1])) \
                    if len(args) >= 2 else (1, max(workload.seq_len, 1))
                time.sleep(self.base_s + self.per_token_s * (plen + olen))
            self.dispatch_order.append(workload.name)
            self.history.append(DispatchRecord(
                workload.name, time.monotonic() - t0, False))
            return {"service": self.prefix, "tokens": olen}
        finally:
            self.inflight -= 1


def sim_builder(base_s: float = 2e-4, per_token_s: float = 2e-6,
                footprint: int = 8 << 20, order_sink: list = None):
    """Manager builder producing one ``SimExecutor`` per instance, keyed
    to the spec's workload name (= the trace's service name)."""
    counter = [0]

    def build(workload: Workload, mesh):
        ex = SimExecutor(f"sim[{workload.name}]{counter[0]}", workload.name,
                         mesh=mesh, base_s=base_s, per_token_s=per_token_s,
                         footprint=footprint)
        if order_sink is not None:
            ex.dispatch_order = order_sink
        counter[0] += 1
        return ex, footprint
    return build

"""Work queue + straggler mitigation (speculative backup dispatch).

The paper rebalances overloaded nodes by moving containers; at step/request
granularity the analogous mechanism is speculative execution: when a
dispatch exceeds ``threshold × median`` of recent latencies, a backup is
launched on a different instance and the first completion wins (classic
MapReduce-style backup tasks, here for serving requests / eval shards).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass
class TaskResult:
    value: Any
    winner: str              # "primary" | "backup"
    wall_s: float
    backup_launched: bool


def clone_args(args: Any) -> Any:
    """Deep-copy dispatch args so a speculative backup never re-dispatches
    the same buffers as its primary.

    Donated-input executors (unikernel images built with
    ``donate_argnums``) invalidate caller buffers on dispatch; racing a
    backup on the SAME args would hand the backup already-donated memory.
    Containers (dict/list/tuple/NamedTuple) recurse; a tensor is cloned
    (``torch.Tensor`` has no ``copy()``, and passing it through would
    let the backup race on the primary's donated buffer), other leaves
    are copied via their own ``copy()`` (numpy arrays) and anything
    without one passes through unchanged (ints, strings, configs — safe
    because immutable or unread by the donating program).
    """
    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, tuple) and hasattr(args, "_fields"):
        return type(args)(*(clone_args(a) for a in args))
    if isinstance(args, tuple):
        return tuple(clone_args(a) for a in args)
    if isinstance(args, list):
        return [clone_args(a) for a in args]
    if isinstance(args, dict):
        return {k: clone_args(v) for k, v in args.items()}
    copy = getattr(args, "copy", None)
    if callable(copy):
        return copy()
    return args


class SpeculativeRunner:
    """Run fn on primary; if slow, race a backup copy."""

    def __init__(self, threshold: float = 2.0, min_history: int = 5,
                 window: int = 50):
        self.threshold = threshold
        self.min_history = min_history
        self.window = window
        self._latencies: List[float] = []
        self._lock = threading.Lock()

    def _budget(self) -> Optional[float]:
        with self._lock:
            hist = self._latencies[-self.window:]
        if len(hist) < self.min_history:
            return None
        return self.threshold * sorted(hist)[len(hist) // 2]

    def _record(self, dt: float):
        with self._lock:
            self._latencies.append(dt)

    def run(self, primary: Callable[[], Any],
            backup: Optional[Callable[[], Any]] = None) -> TaskResult:
        """Run ``primary``; race/fall back to ``backup`` when available.

        An erroring copy never wins the race: a fast-failing primary
        triggers the backup immediately, and ``run`` raises only when
        every launched copy has failed.  ``_latencies`` records each
        winner's OWN execution time (measured inside its thread), not the
        caller-observed wall — race-wait time must not inflate the median
        that sets future backup budgets.
        """
        budget = self._budget()
        t0 = time.monotonic()
        if budget is None:
            # not enough history to race; still fall back on error
            try:
                out = primary()
            except Exception:
                if backup is None:
                    raise
                t1 = time.monotonic()
                out = backup()          # raises if all copies fail
                dt = time.monotonic() - t1
                self._record(dt)
                return TaskResult(out, "backup",
                                  time.monotonic() - t0, True)
            dt = time.monotonic() - t0
            self._record(dt)
            return TaskResult(out, "primary", dt, False)
        if backup is None:
            out = primary()
            dt = time.monotonic() - t0
            self._record(dt)
            return TaskResult(out, "primary", dt, False)

        # (tag, ok, value-or-error, own_wall_s)
        result_q: "queue.Queue[Tuple[str, bool, Any, float]]" = queue.Queue()

        def wrap(tag, fn):
            def go():
                ts = time.monotonic()
                try:
                    val = fn()
                    result_q.put((tag, True, val, time.monotonic() - ts))
                except Exception as e:  # noqa: BLE001
                    result_q.put((tag, False, e, time.monotonic() - ts))
            return go

        threading.Thread(target=wrap("primary", primary),
                         daemon=True).start()
        launched, backup_launched = 1, False

        def launch_backup():
            nonlocal launched, backup_launched
            backup_launched = True
            launched += 1
            threading.Thread(target=wrap("backup", backup),
                             daemon=True).start()

        try:
            tag, ok, val, dt = result_q.get(timeout=budget)
        except queue.Empty:             # primary straggles → race a backup
            launch_backup()
            tag, ok, val, dt = result_q.get()
        failures = 0
        while not ok:                   # an error must not win the race
            failures += 1
            if not backup_launched:
                launch_backup()
            if failures >= launched:
                raise val               # every launched copy failed
            tag, ok, val, dt = result_q.get()
        self._record(dt)                # winner's own latency, not the wall
        return TaskResult(val, tag, time.monotonic() - t0, backup_launched)


class WorkQueue:
    """Bounded FIFO with depth telemetry — feeds the autoscaler."""

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=maxsize)
        self.enqueued = 0
        self.dequeued = 0

    def put(self, item: Any):
        self._q.put(item)
        self.enqueued += 1

    def get(self, timeout: Optional[float] = None) -> Any:
        item = self._q.get(timeout=timeout)
        self.dequeued += 1
        return item

    def depth(self) -> int:
        return self._q.qsize()

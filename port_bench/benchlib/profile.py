"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, reduced from the raw events without writing a trace file.

``summary()`` gives the window's length, the seconds in which some
operation ran on the device (the union of the device events' intervals),
each device operation's seconds by name, and the idle gaps, each named by
the innermost host event running at its middle on the thread with the
most of them (on the card a CUDA runtime call; ``"python"`` where none
ran: the interpreter between launches).
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

GAP_MIN_S = 20e-6            # shorter gaps are a launch's own latency
LOOK_BACK = 256
NAME_CHARS = 160             # a kernel's name, cut (templates run long)


def _span(e) -> Tuple[int, int]:
    return e.start_ns(), e.start_ns() + e.duration_ns()


class DeviceTrace:
    """``prime`` in set-up (a process's first profiler start takes about
    10 s, which would stall the window's schedule), ``start`` shortly
    before the window, ``open``/``close`` at its edges, ``stop`` after the
    drain.  On the card the trace records CUDA activity alone (kernels and
    the runtime calls that launch them): recording every host operation
    slowed the engine past the drain's limit.  The window's bounds are the
    host's clock at its edges, the clock the trace's events carry."""

    def __init__(self):
        self._prof = None
        self._ws = self._we = 0

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA]
                       if torch.cuda.is_available()
                       else [ProfilerActivity.CPU])

    def prime(self):
        with self._profile():
            pass

    def start(self):
        if self._prof is not None:
            raise RuntimeError("the trace has started already")
        self._prof = self._profile()
        self._prof.start()

    def open(self):
        self._ws = time.time_ns()

    def close(self):
        self._we = time.time_ns()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def summary(self) -> dict:
        events = list(self._prof.profiler.kineto_results.events())
        ws, we = self._ws, self._we
        dev, host = [], collections.defaultdict(list)
        for e in events:
            a, b = _span(e)
            if b <= ws or a >= we or e.duration_ns() <= 0:
                continue
            if "CUDA" in str(e.device_type()):
                dev.append((max(a, ws), min(b, we), e.name()))
            else:
                host[e.start_thread_id()].append(e)
        out = {"window_s": (we - ws) * 1e-9, "busy_s": 0.0, "kernel_s": {},
               "gaps": {}}
        if not dev:
            return out
        kernel_s: Dict[str, float] = collections.defaultdict(float)
        for a, b, name in dev:
            kernel_s[name[:NAME_CHARS]] += (b - a) * 1e-9
        merged: List[List[int]] = []
        for a, b, _ in sorted(dev):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [ws] + [x for ab in merged for x in ab] + [we]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if (edges[i + 1] - edges[i]) * 1e-9 >= GAP_MIN_S]
        out.update(busy_s=sum(b - a for a, b in merged) * 1e-9,
                   kernel_s=dict(kernel_s), gaps=_name_gaps(gaps, host))
        return out


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device by the host operation running at each gap's
    middle on the thread with the most host events."""
    if not host or not gaps:
        return {}
    ops = sorted((_span(e) + (e.name(),)
                  for e in max(host.values(), key=len)))
    starts = [o[0] for o in ops]
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        name = "python"
        # the innermost op holding ``mid``: the latest-starting one that
        # has not ended (ops on one thread nest); an enclosing op lies
        # behind its earlier children, so look back a bounded way
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - LOOK_BACK, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        out[name] += (b - a) * 1e-9
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

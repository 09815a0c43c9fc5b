"""The system under test, deployed as ``launch/serve.py`` deploys it, and
the loops that drive it.

Set-up: an ``EdgeSystem`` node, ``make_engine_builder`` with the
benchmark's weights (``params=``) and the configuration's engine
settings, one container-class ``ServiceSpec``; the engine is warmed up and
its background loop started.  The window then calls only
``ServingEngine.submit``, the call ``EngineExecutor.dispatch`` makes, from
this process's main thread: an open loop at the times the traffic gives,
or a closed loop that sends a client's next turn when its answer returns.

What the harness reads of the program: the requests' public fields
(``generated``, ``pos``, ``kv_shared_tokens``, ``admitted_at``,
``first_token_at``, ``finished_at``, ``error``) and the engine's public
counters (``ticks``, ``decode_steps``, ``chunks_run``) and ``active``
map, at the window's two edges and after it.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional

import numpy as np

ENGINE_KEYS = ("max_slots", "max_seq", "page_size", "num_pages",
               "prefill_chunk", "prefill_budget")


def deploy(model: dict, engine: dict, weights, device):
    """``(system, engine)``: the engine deployed through the control plane,
    warmed up, its loop running."""
    from repro_torch.core import (EdgeSystem, ExecutorClass, QoSClass,
                                  ServiceSpec, Workload, WorkloadClass,
                                  WorkloadKind)
    from repro_torch.core.resources import host_capacity
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.router import make_engine_builder

    if not isinstance(engine["prefill_budget"], int):
        raise ValueError("prefill_budget must be a fixed number of tokens")
    cfg = ModelConfig(**model)
    system = EdgeSystem()
    system.add_node("edge0", host_capacity(device))
    system.register_builder(
        "decode", WorkloadClass.HEAVY,
        make_engine_builder(cfg, params=weights, device=device,
                            **{k: engine[k] for k in ENGINE_KEYS}))
    spec = ServiceSpec(
        name="llm-serving",
        workload=Workload("serve", WorkloadKind.DECODE, cfg,
                          batch=engine["max_slots"], seq_len=1),
        executor_class=ExecutorClass.CONTAINER, tenant="serving",
        qos=QoSClass.GUARANTEED)
    (dep,) = system.apply(spec)
    eng = dep.executor.engine
    eng.warmup()
    eng.start()
    return system, eng


@dataclasses.dataclass(eq=False)
class Sent:
    """One request the harness sent.  ``due``: when an open loop meant to
    send it (``None`` in a closed loop)."""
    prompt: np.ndarray
    max_new: int
    handle: object
    due: Optional[float]
    sent: float

    def request(self):
        """The engine's finished ``Request``, or ``None`` while it runs or
        when it failed."""
        f = self.handle.future
        if not f.done() or f.exception() is not None:
            return None
        return f.result()

    def error(self) -> Optional[str]:
        f = self.handle.future
        if f.done() and f.exception() is not None:
            return repr(f.exception())
        return None


@dataclasses.dataclass
class Edge:
    """A snapshot at one edge of the window: its time, the engine's
    counters and queued requests, and each sent request's (tokens
    generated, prompt tokens in the cache, prompt tokens attached from
    the radix)."""
    t: float
    ticks: int
    decode_steps: int
    chunks_run: int
    queued: int
    progress: List[tuple]
    preemptions: int = 0


class Driver:
    """Sends requests to ``engine`` and snapshots their progress."""

    def __init__(self, engine):
        self.engine = engine
        self.sent: List[Sent] = []

    def submit(self, prompt, max_new: int, due=None) -> Sent:
        h = self.engine.submit(prompt, max_new_tokens=max_new)
        s = Sent(prompt, max_new, h, due, time.monotonic())
        self.sent.append(s)
        return s

    def edge(self) -> Edge:
        eng = self.engine
        t = time.monotonic()
        active = dict(eng.active)
        counters = (eng.ticks, eng.decode_steps, eng.chunks_run,
                    len(eng.queue))
        preempted = eng.preemptions
        prog = []
        for s in self.sent:
            req = active.get(s.handle.rid)
            if req is None:
                req = s.request()
            prog.append((0, 0, 0) if req is None else
                        (len(req.generated), req.pos, req.kv_shared_tokens))
        return Edge(t, *counters, prog, preempted)


def run_open(engine, plan: Dict[str, list], lead_s: float, window_s: float,
             drain_s: float, on_edge: Callable[[str], None],
             warm_s: float = 0.0):
    """Send ``plan["requests"]`` at their offsets from the window's start
    (which comes ``lead_s`` from now), snapshot both edges, and after the
    window keep the schedule going until every request due in it (between
    the edges' snapshots) has finished or ``drain_s`` has passed.
    ``on_edge`` hears ``"warm"`` ``warm_s`` before the window's start,
    then ``"start"`` and ``"end"``.  Returns ``(driver, start, end)``."""
    drv = Driver(engine)
    reqs = sorted(plan["requests"], key=lambda r: r["offset_s"])
    t0 = time.monotonic() + lead_s
    t1 = t0 + window_s
    edges: Dict[str, Edge] = {}
    warm = False
    i = 0
    while True:
        now = time.monotonic()
        if not warm and now >= t0 - warm_s:
            on_edge("warm")
            warm = True
            continue
        if "start" not in edges and now >= t0:
            on_edge("start")
            edges["start"] = drv.edge()
            t1 = edges["start"].t + window_s    # after the trace's start
            continue
        if "end" not in edges and now >= t1:
            edges["end"] = drv.edge()
            on_edge("end")
            a, b = edges["start"].t, edges["end"].t
            window = [s for s in drv.sent if a <= s.due < b]
            continue
        if "end" in edges and (now >= t1 + drain_s or all(
                s.handle.future.done() for s in window)):
            break
        if i < len(reqs) and t0 + reqs[i]["offset_s"] <= now:
            r = reqs[i]
            s = drv.submit(r["prompt"], r["max_new"], t0 + r["offset_s"])
            if "end" in edges and a <= s.due < b:
                window.append(s)
            i += 1
            continue
        nxt = [t0 + reqs[i]["offset_s"]] if i < len(reqs) else []
        nxt += [t for k, t in (("start", t0), ("end", t1))
                if k not in edges]
        nxt += [] if warm else [t0 - warm_s]
        wake = min(nxt + [now + 0.05])
        time.sleep(max(0.0, wake - now))
    return drv, edges["start"], edges["end"]


def settle(engine, sent: List[Sent], wait_s: float) -> List[dict]:
    """Wait up to ``wait_s`` more for those of ``sent`` still running once
    the drain's time is up, sending nothing more: they are late, not lost,
    and their latencies count the wait.  Returns, for each, its state when
    the wait began (``phase``, tokens ``generated``) and, after the wait,
    whether it ``finished`` or its ``error``."""
    pending = [s for s in sent if not s.handle.future.done()]
    if not pending:
        return []
    queued = {r.rid for r in list(engine.queue)}
    active = dict(engine.active)
    out = []
    for s in pending:
        r = active.get(s.handle.rid)
        out.append({"sent": s,
                    "phase": "queued" if s.handle.rid in queued
                    else r.phase if r is not None else "unknown",
                    "generated": len(r.generated) if r is not None else 0})
    deadline = time.monotonic() + wait_s
    for s in pending:
        try:
            s.handle.future.result(
                timeout=max(0.0, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 — judged below by the future
            pass
    for d in out:
        d["finished"] = d["sent"].request() is not None
        d["error"] = d["sent"].error()
    return out


def run_closed(engine, frames, lead_s: float, window_s: float,
               on_edge: Callable[[str], None], warm_s: float = 0.0):
    """``frames.clients`` clients, each from ``frames.start_s(client)``
    sending a frame's turns one after another (a follow-up is the previous
    prompt, its answer and a new question) and then its next frame, until
    the window, which starts ``lead_s`` from now, ends.  ``on_edge`` as in
    ``run_open``.  Returns ``(driver, start, end)``."""
    drv = Driver(engine)
    done: "queue.Queue[int]" = queue.Queue()
    state = {}

    def send(c: int, prompt, max_new: int):
        s = drv.submit(prompt, max_new)
        state[c]["sent"] = s
        s.handle.future.add_done_callback(lambda _f, c=c: done.put(c))

    def next_frame(c: int):
        st = state.setdefault(c, {"k": -1})
        st["k"] += 1
        st["frame"] = frames.frame(c, st["k"])
        st["turn"] = 0
        q, a = st["frame"]["turns"][0]
        send(c, np.concatenate([frames.header, st["frame"]["image"], q]), a)

    begin = time.monotonic()
    starts = sorted((begin + frames.start_s(c), c)
                    for c in range(frames.clients))
    t0 = begin + lead_s
    t1 = t0 + window_s
    edges: Dict[str, Edge] = {}
    warm = False
    while "end" not in edges:
        now = time.monotonic()
        if not warm and now >= t0 - warm_s:
            on_edge("warm")
            warm = True
            continue
        if starts and starts[0][0] <= now:
            next_frame(starts.pop(0)[1])
            continue
        if "start" not in edges and now >= t0:
            on_edge("start")
            edges["start"] = drv.edge()
            t1 = edges["start"].t + window_s    # after the trace's start
            continue
        if now >= t1:
            edges["end"] = drv.edge()
            on_edge("end")
            break
        wake = t0 if "start" not in edges else t1
        if not warm:
            wake = min(wake, t0 - warm_s)
        if starts:
            wake = min(wake, starts[0][0])
        try:
            c = done.get(timeout=max(0.0, wake - now))
        except queue.Empty:
            continue
        st = state[c]
        req = st["sent"].request()
        st["turn"] += 1
        if req is None or st["turn"] >= len(st["frame"]["turns"]):
            next_frame(c)
            continue
        q, a = st["frame"]["turns"][st["turn"]]
        send(c, np.concatenate([st["sent"].prompt,
                                np.asarray(req.generated, np.int32), q]), a)
    return drv, edges["start"], edges["end"]

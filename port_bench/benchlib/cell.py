"""One run of one cell: set-up, the measured window, the metrics, the
check of what was served.

``run`` returns the result line's object and the compared numbers; the
caller (``run.py``) decides whether it may print it.  ``device`` is the
card in every run of the benchmark; the CPU tests pass ``cpu`` and small
sizes to drive the same path with the kernels' plain versions.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Optional

from benchlib import check, serve
from benchlib.profile import DeviceTrace, top
from benchlib.spec import Cell
from benchlib.window import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run starts the profiler this long before the window (primed in
# set-up, it starts in milliseconds); the rest of the lead-in goes
# untraced, so that reducing the trace stays well inside a run's limit
TRACE_LEAD_S = 2.0
# after an open loop's drain, the longest the harness waits, sending
# nothing, for the window's requests still running (late, not lost)
SETTLE_S = 45.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch`` is another name and passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        started: float, keep: Optional[dict] = None):
    """``(result, checks)``.  ``started``: the process's start on the
    monotonic clock.  ``keep`` receives the weights and the served sample,
    for a caller that reads the control on them."""
    import torch

    model = cell.config["model"]
    engine = cell.config["engine"]
    traffic = cell.traffic
    vocab = cell.config["vocab"]
    cuda = torch.device(device).type == "cuda"
    ref = cell.reference()
    gen = cell.generator()

    weights = ref.make_weights(model, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    system, eng = serve.deploy(model, engine, weights, device)
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.prime()

    def on_edge(which: str):
        if tracer is not None:
            {"warm": tracer.start, "start": tracer.open,
             "end": tracer.close}[which]()

    lead = traffic["lead_s"]
    if gen.LOOP == "open":
        plan = gen.generate(traffic, vocab, seed, lead_s=lead,
                            window_s=seconds, tail_s=traffic["drain_s"])
        # set-up the traffic needs: the documents served once, so that
        # the prefix cache holds them when the traffic starts
        pre = [eng.submit(p, max_new_tokens=1) for p in plan["preload"]]
        for h in pre:
            h.result(timeout=600)
        del pre
        drv, start, end = serve.run_open(eng, plan, lead, seconds,
                                         traffic["drain_s"], on_edge,
                                         TRACE_LEAD_S)
        late = serve.settle(
            eng, [s for s in drv.sent if start.t <= s.due < end.t],
            SETTLE_S)
    else:
        frames = gen.generate(traffic, vocab, seed)
        drv, start, end = serve.run_closed(eng, frames, lead, seconds,
                                           on_edge, TRACE_LEAD_S)
        late = []
    closed_at = time.monotonic()
    eng.stop(drain=False)
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prof = tracer.summary() if tracer is not None else None
    win = Window(model, engine, drv.sent, start, end, closed_at,
                 gen.LOOP == "open", start.t - started, peak, prof)

    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(win)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    lost = len(win.lost())
    finished = []
    for s in win.requests:
        r = s.request()
        if r is not None and (win.open_loop or r.finished_at < end.t):
            finished.append((s.prompt, list(r.generated)))
    attempted = len(win.requests)
    w = win.work()
    result = {"correct": False, "attempted": attempted, "failed": lost,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if prof is not None:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": top(prof["kernel_s"]),
                               "idle_gaps": top(prof["gaps"])}
    work = {k: w[k] for k in ("rows", "steps", "ticks", "tokens",
                              "chunks_run")}
    work["chunks"] = len(w["chunks"])
    work["preemptions"] = end.preemptions - start.preemptions
    late = [[round(d["sent"].due - end.t, 3), len(d["sent"].prompt),
             d["sent"].max_new, d["phase"], d["generated"],
             "finished" if d["finished"] else d["error"] or "running"]
            for d in late]
    for due, plen, ask, phase, gen_, how in late:
        print(f"late request: due {due:+.3f} s from the window's end, "
              f"prompt {plen}, asks {ask}; {phase} with {gen_} tokens when "
              f"the drain ended; after {SETTLE_S:g} s more: {how}",
              file=sys.stderr)
    lat = {"ttft_ms": win.latencies_ms("first_token_at"),
           "tpot_ms": win.tpot_ms(), "queued": (start.queued, end.queued)}

    # the program's state goes before the reference runs beside the
    # weights
    del system, eng, drv, win, start, end
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = check.sample(finished, seed, traffic["check_tokens"],
                          traffic["check_requests"])
    gap = check.widest_gap(ref, weights, model, picked, device) \
        if picked else None
    if keep is not None:
        keep.update(weights=weights, model=model, picked=picked, ref=ref,
                    **lat)
    limits = cell.limits["limits"]
    checks = [("logit_gap", gap, limits["logit_gap"]),
              ("lost_requests", lost, 0)]
    result["correct"] = all(v is not None and v <= lim
                            for _, v, lim in checks)
    result["work"] = work
    result["late"] = late
    result["check"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in checks}
    return result, checks

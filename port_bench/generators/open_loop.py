"""Open-loop arrivals: requests due on a schedule, whatever the system does.

Parameters (a traffic file's keys):

- ``rate_rps``: arrivals a second, in every segment of the run;
- ``prompt``: ``{"median", "sigma", "min", "max"}``, a lognormal clipped
  to ``[min, max]``, of fresh text ids; or, with ``docs``, ``{"min",
  "max"}``, a uniform question length after the document;
- ``output``: the same lognormal form, the tokens each request asks for;
- ``docs`` (optional): ``{"count", "min", "max", "zipf_s"}``: ``count``
  documents of uniform length, each request opening with one picked by
  Zipf popularity of exponent ``zipf_s`` (rank r with weight r^-s);
  ``preload`` (a bool) serves each once in set-up;
- ``shape_seed``: the seed of every size and gap;
- ``check_tokens``, ``check_requests``: the least served tokens and
  requests the check of a run compares (``benchlib/check.py``).

Every seed gets the same work: the sizes, the gaps between arrivals and
the documents' lengths and popularity come from ``shape_seed``, and the
run's seed only rotates each segment's sequence of (gap, request) to
start at another place and draws the token ids.  Each segment of the
run (lead-in, window, tail) holds ``round(rate · length)`` arrivals, so
the window's work is the same on every seed; a rotation keeps the
bursts of the schedule whole, so the window's tail latencies do not
swing with the seed as they would under a shuffle.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchlib.draws import lognormal, zipf_ranks

LOOP = "open"


def _segment(shape, run, t0: float, length: float, rate: float,
             traffic: dict) -> List[dict]:
    n = int(round(rate * length))
    if n == 0:
        return []
    # arrival gaps of a Poisson process with n arrivals in the segment,
    # rotated to start where the run's seed says
    times = np.sort(shape.uniform(0.0, length, size=n))
    gaps = np.diff(np.concatenate([[0.0], times]))
    order = np.roll(np.arange(n), -int(run.integers(n)))
    offsets = t0 + np.cumsum(gaps[order])
    out = lognormal(shape, traffic["output"], n)[order]
    docs = traffic.get("docs")
    if docs:
        q = shape.integers(traffic["prompt"]["min"],
                           traffic["prompt"]["max"] + 1, size=n)[order]
        rank = zipf_ranks(shape, docs["count"], docs["zipf_s"], n)[order]
    else:
        q = lognormal(shape, traffic["prompt"], n)[order]
        rank = np.full(n, -1)
    return [{"offset_s": float(offsets[i]), "fresh": int(q[i]),
             "doc": int(rank[i]), "max_new": int(out[i])} for i in range(n)]


def generate(traffic: dict, vocab: dict, seed: int, lead_s: float,
             window_s: float, tail_s: float) -> Dict[str, list]:
    """``{"requests": [...], "preload": [...]}``.  A request is
    ``{"offset_s", "prompt", "max_new", "doc"}`` with ``offset_s`` from
    the window's start (negative in the lead-in); ``preload`` lists the
    prompts set-up serves before any traffic."""
    shape = np.random.default_rng(traffic["shape_seed"])
    run = np.random.default_rng(int(seed))
    lo, hi = vocab["text"]
    docs = traffic.get("docs")
    doc_tokens = []
    if docs:
        lens = shape.integers(docs["min"], docs["max"] + 1,
                              size=docs["count"])
        doc_tokens = [run.integers(lo, hi, size=int(n), dtype=np.int64)
                      .astype(np.int32) for n in lens]
    reqs = []
    for t0, length in ((-lead_s, lead_s), (0.0, window_s),
                       (window_s, tail_s)):
        reqs += _segment(shape, run, t0, length, traffic["rate_rps"],
                         traffic)
    for r in reqs:
        fresh = run.integers(lo, hi, size=r.pop("fresh"),
                             dtype=np.int64).astype(np.int32)
        r["prompt"] = np.concatenate([doc_tokens[r["doc"]], fresh]) \
            if r["doc"] >= 0 else fresh
    preload = list(doc_tokens) if docs and docs.get("preload") else []
    return {"requests": reqs, "preload": preload}

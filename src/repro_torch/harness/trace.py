"""Replayable workload traces — versioned, seed-deterministic JSONL; the
port of ``repro.harness.trace``.

The paper's evaluation (and Carpio et al.'s edge-benchmarking argument in
PAPERS.md) judges an edge system under *measured* arrival patterns, not
synthetic single-scenario loops.  A ``Trace`` is the unit of that
judgement here: an ordered stream of ``TraceEvent`` arrivals (offset from
trace start, tenant, QoS class, target service, prompt/output lengths,
session/prefix-group id) plus a header carrying the generator knobs and
the per-service spec defaults a replay needs to reconstruct the cluster.

Determinism contract: every generator is a pure function of its keyword
arguments — the same ``seed`` produces a byte-for-byte identical
``to_jsonl()`` stream, byte for byte the JAX package's for the same
knobs (asserted by ``tests/test_torch_harness.py``), so a scorecard
regression can never be blamed on workload drift.

Four built-in generators cover the paper's workload families:

* ``diurnal_chat``    — sinusoidal-rate multi-turn chat (sessions share a
                        prefix group; prompts grow with history),
* ``iot_burst``       — low-rate sensor telemetry with periodic
                        coordinated bursts and rare GUARANTEED alarms,
* ``longdoc_batch``   — sparse batches of long-prompt document jobs,
* ``forked_chat``     — sessions branching off one shared system-prompt
                        header at configurable fork depths (divergent
                        prefixes — the prefix-sharing COW workload).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.spec import QoSClass

TRACE_VERSION = 1


def _round(x: float, nd: int = 6) -> float:
    """Stable float for JSONL round-trips (repr of a rounded float is
    deterministic across runs and platforms)."""
    return round(float(x), nd)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival.  ``offset_s`` is seconds from trace start (trace
    time — the replayer may compress it); ``session`` groups multi-turn /
    prefix-sharing requests (the prefix-cache frontier keys on it)."""
    eid: int
    offset_s: float
    tenant: str
    qos: str                        # QoSClass value string
    service: str
    prompt_len: int
    output_len: int
    session: str = ""
    latency_slo_ms: float = 0.0     # 0 → no SLO on this event

    def __post_init__(self):
        QoSClass(self.qos)          # validate eagerly, raise on bad traces
        if self.prompt_len <= 0 or self.output_len <= 0:
            raise ValueError(
                f"event {self.eid}: prompt/output lengths must be positive")
        if self.offset_s < 0:
            raise ValueError(f"event {self.eid}: negative offset")

    @property
    def qos_class(self) -> QoSClass:
        return QoSClass(self.qos)

    def to_dict(self) -> dict:
        return {
            "kind": "event",
            "eid": self.eid,
            "offset_s": _round(self.offset_s),
            "tenant": self.tenant,
            "qos": self.qos,
            "service": self.service,
            "prompt_len": self.prompt_len,
            "output_len": self.output_len,
            "session": self.session,
            "latency_slo_ms": _round(self.latency_slo_ms, 3),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(eid=d["eid"], offset_s=d["offset_s"], tenant=d["tenant"],
                   qos=d["qos"], service=d["service"],
                   prompt_len=d["prompt_len"], output_len=d["output_len"],
                   session=d.get("session", ""),
                   latency_slo_ms=d.get("latency_slo_ms", 0.0))


@dataclasses.dataclass(frozen=True)
class Trace:
    """Header + ordered events.  ``meta["services"]`` maps each service
    name to its replay defaults (tenant, qos, latency_slo_ms, weight) so
    ``harness.replay.specs_for_trace`` can rebuild the cluster."""
    name: str
    seed: int
    duration_s: float
    events: Tuple[TraceEvent, ...]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    version: int = TRACE_VERSION

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------- serialization
    def header(self) -> dict:
        return {"kind": "trace", "version": self.version, "name": self.name,
                "seed": self.seed, "duration_s": _round(self.duration_s),
                "meta": self.meta}

    def to_jsonl(self) -> str:
        lines = [json.dumps(self.header(), sort_keys=True,
                            separators=(",", ":"))]
        lines += [json.dumps(e.to_dict(), sort_keys=True,
                             separators=(",", ":")) for e in self.events]
        return "\n".join(lines) + "\n"

    def fingerprint(self) -> str:
        """sha256 of the JSONL stream — the byte-for-byte identity the
        determinism contract is asserted on."""
        return hashlib.sha256(self.to_jsonl().encode()).hexdigest()

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace stream")
        head = json.loads(lines[0])
        if head.get("kind") != "trace":
            raise ValueError("first JSONL record must be the trace header")
        if head.get("version") != TRACE_VERSION:
            raise ValueError(
                f"trace version {head.get('version')} != {TRACE_VERSION}")
        events = tuple(TraceEvent.from_dict(json.loads(ln))
                       for ln in lines[1:])
        return cls(name=head["name"], seed=head["seed"],
                   duration_s=head["duration_s"], events=events,
                   meta=head.get("meta", {}), version=head["version"])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_jsonl(f.read())


# --------------------------------------------------------------------------
# generator plumbing
# --------------------------------------------------------------------------

def _thinned_poisson(rng: np.random.Generator, duration_s: float,
                     rate_fn: Callable[[float], float],
                     rate_max: float) -> List[float]:
    """Non-homogeneous Poisson arrivals by thinning (Lewis–Shedler)."""
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= duration_s:
            return out
        if rng.random() < rate_fn(t) / rate_max:
            out.append(t)


def _clip_int(x: float, lo: int, hi: int) -> int:
    return int(min(max(x, lo), hi))


def _finish(name: str, seed: int, duration_s: float,
            raw: Iterable[Tuple[float, str, QoSClass, str, int, int, str,
                                float]],
            services: Dict[str, dict], knobs: Dict[str, object]) -> Trace:
    """Sort by offset, assign eids, wrap with the service/knob metadata.

    Floats are rounded here — at generation, not just at serialization —
    so an in-memory trace equals its JSONL round-trip exactly."""
    rows = sorted(((_round(r[0]),) + tuple(r[1:]) for r in raw),
                  key=lambda r: (r[0], r[3], r[1]))
    events = tuple(
        TraceEvent(eid=i, offset_s=off, tenant=tenant, qos=qos.value,
                   service=service, prompt_len=plen, output_len=olen,
                   session=session, latency_slo_ms=_round(slo, 3))
        for i, (off, tenant, qos, service, plen, olen, session, slo)
        in enumerate(rows))
    meta = {"generator": name, "services": services, "knobs": knobs}
    return Trace(name=name, seed=seed, duration_s=_round(duration_s),
                 events=events, meta=meta)


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def diurnal_chat(seed: int = 0, duration_s: float = 30.0,
                 day_s: Optional[float] = None, base_rps: float = 2.0,
                 peak_rps: float = 6.0, pro_fraction: float = 0.35,
                 continue_p: float = 0.6, max_turns: int = 6) -> Trace:
    """Multi-turn chat under a compressed diurnal rate curve.

    The arrival rate follows one full "day": trough at t=0, peak at
    ``day_s/2``.  Each arrival either opens a session or (with
    ``continue_p``) continues an open one for its tenant — continued
    turns share the session id (the prefix group) and their prompts grow
    with accumulated history, the shape prefix-caching feeds on.
    """
    rng = np.random.default_rng(seed)
    day = duration_s if day_s is None else day_s

    def rate(t: float) -> float:
        return base_rps + (peak_rps - base_rps) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / day))

    services = {"chat": {"tenant": "chat-free", "qos": "burstable",
                         "latency_slo_ms": 800.0}}
    raw = []
    open_sessions: Dict[str, List[Tuple[str, int, int]]] = {}
    sid = 0
    for off in _thinned_poisson(rng, duration_s, rate, peak_rps):
        pro = rng.random() < pro_fraction
        tenant = "chat-pro" if pro else "chat-free"
        qos = QoSClass.GUARANTEED if pro else QoSClass.BURSTABLE
        slo = 400.0 if pro else 800.0
        pool = open_sessions.setdefault(tenant, [])
        if pool and rng.random() < continue_p:
            i = int(rng.integers(len(pool)))
            session, turn, hist = pool[i]
            turn += 1
            hist += _clip_int(rng.lognormal(3.2, 0.5), 16, 256)
            if turn >= max_turns:
                pool.pop(i)
            else:
                pool[i] = (session, turn, hist)
        else:
            session, turn, hist = f"chat-s{sid}", 0, 0
            sid += 1
            pool.append((session, 1, _clip_int(rng.lognormal(3.2, 0.5),
                                               16, 256)))
        plen = _clip_int(rng.lognormal(3.5, 0.6), 8, 512) + hist
        olen = _clip_int(rng.lognormal(3.6, 0.7), 8, 256)
        raw.append((off, tenant, qos, "chat", min(plen, 1024), olen,
                    session, slo))
    knobs = {"base_rps": base_rps, "peak_rps": peak_rps, "day_s": day,
             "pro_fraction": pro_fraction, "continue_p": continue_p,
             "max_turns": max_turns}
    return _finish("diurnal-chat", seed, duration_s, raw, services, knobs)


def iot_burst(seed: int = 0, duration_s: float = 30.0,
              background_rps: float = 4.0, burst_period_s: float = 10.0,
              burst_size: int = 30, burst_span_s: float = 0.5,
              alarm_rps: float = 0.15) -> Trace:
    """Bursty IoT telemetry: steady BEST_EFFORT sensor readings, periodic
    coordinated bursts (a fleet reporting on one clock edge — every burst
    shares a session/prefix group), and rare GUARANTEED alarms with a
    tight SLO on their own ``alerts`` service."""
    rng = np.random.default_rng(seed)
    services = {
        "telemetry": {"tenant": "sensors", "qos": "best-effort",
                      "latency_slo_ms": 600.0},
        "alerts": {"tenant": "safety", "qos": "guaranteed",
                   "latency_slo_ms": 250.0},
    }
    raw = []
    for off in _thinned_poisson(rng, duration_s, lambda _t: background_rps,
                                background_rps):
        raw.append((off, "sensors", QoSClass.BEST_EFFORT, "telemetry",
                    _clip_int(rng.integers(4, 17), 4, 16),
                    _clip_int(rng.integers(1, 9), 1, 8),
                    f"dev{int(rng.integers(64))}", 600.0))
    k, t = 0, burst_period_s / 2.0
    while t < duration_s:
        for _ in range(burst_size):
            off = t + float(rng.uniform(0.0, burst_span_s))
            if off >= duration_s:
                continue
            raw.append((off, "sensors", QoSClass.BEST_EFFORT, "telemetry",
                        _clip_int(rng.integers(4, 17), 4, 16),
                        _clip_int(rng.integers(1, 9), 1, 8),
                        f"burst{k}", 600.0))
        k += 1
        t += burst_period_s
    for off in _thinned_poisson(rng, duration_s, lambda _t: alarm_rps,
                                alarm_rps):
        raw.append((off, "safety", QoSClass.GUARANTEED, "alerts",
                    _clip_int(rng.integers(8, 25), 8, 24),
                    _clip_int(rng.integers(4, 17), 4, 16),
                    f"alarm{int(rng.integers(16))}", 250.0))
    knobs = {"background_rps": background_rps,
             "burst_period_s": burst_period_s, "burst_size": burst_size,
             "burst_span_s": burst_span_s, "alarm_rps": alarm_rps}
    return _finish("iot-burst", seed, duration_s, raw, services, knobs)


def longdoc_batch(seed: int = 0, duration_s: float = 30.0,
                  batch_period_s: float = 8.0, docs_per_batch: int = 6,
                  straggler_rps: float = 0.2) -> Trace:
    """Long-document batch ingestion: sparse coordinated batches of
    long-prompt jobs (each batch one prefix group) plus a trickle of
    ad-hoc stragglers — the prefill-heavy mix that stresses chunked
    prefill and the per-tick token budget."""
    rng = np.random.default_rng(seed)
    services = {"batchdoc": {"tenant": "archive", "qos": "burstable",
                             "latency_slo_ms": 5000.0}}
    raw = []
    k, t = 0, batch_period_s / 2.0
    while t < duration_s:
        for _ in range(docs_per_batch):
            off = t + float(rng.uniform(0.0, 1.0))
            if off >= duration_s:
                continue
            raw.append((off, "archive", QoSClass.BURSTABLE, "batchdoc",
                        _clip_int(rng.lognormal(6.2, 0.5), 256, 2048),
                        _clip_int(rng.lognormal(4.6, 0.5), 32, 256),
                        f"doc-batch{k}", 5000.0))
        k += 1
        t += batch_period_s
    for off in _thinned_poisson(rng, duration_s, lambda _t: straggler_rps,
                                straggler_rps):
        raw.append((off, "archive", QoSClass.BURSTABLE, "batchdoc",
                    _clip_int(rng.lognormal(6.0, 0.6), 128, 2048),
                    _clip_int(rng.lognormal(4.2, 0.5), 16, 256),
                    "", 5000.0))
    knobs = {"batch_period_s": batch_period_s,
             "docs_per_batch": docs_per_batch,
             "straggler_rps": straggler_rps}
    return _finish("longdoc-batch", seed, duration_s, raw, services, knobs)


def forked_chat(seed: int = 0, duration_s: float = 10.0, rps: float = 6.0,
                sessions: int = 8, header_tokens: int = 48,
                fork_depths: Tuple[int, ...] = (16, 32, 48),
                turn_tokens: int = 16, max_prompt: int = 192,
                output_len: int = 6, guaranteed_fraction: float = 0.25,
                slo_ms: float = 2500.0,
                service: str = "forked-chat") -> Trace:
    """Divergent-prefix chat: every session shares one system-prompt +
    few-shot header and **forks** off it at a session-specific depth —
    fork points, not just growing turns.

    Session ``s`` copies the common header up to
    ``fork_depths[s % len(fork_depths)]`` tokens and then diverges into
    its own history, so a replay sees (a) many requests whose prompts are
    byte-identical up to a mid-stream fork (the radix/COW sharing case),
    and (b) per-session multi-turn growth past the fork (the tail-append
    case).  The session id encodes the fork depth (``fork{d}-s{n}``) so
    ``engine_replay.make_forked_engine_item`` can synthesize token
    streams that really do share the header prefix and diverge at ``d``.
    Turn ``t`` of a session has ``prompt_len = depth + (t+1) *
    turn_tokens`` (clipped to ``max_prompt``) — prefix-stable growth.
    """
    rng = np.random.default_rng(seed)
    services = {service: {"tenant": "chat", "qos": "burstable",
                          "latency_slo_ms": slo_ms}}
    turns = [0] * sessions
    raw = []
    for off in _thinned_poisson(rng, duration_s, lambda _t: rps, rps):
        s = int(rng.integers(sessions))
        depth = int(fork_depths[s % len(fork_depths)])
        depth = max(1, min(depth, header_tokens))
        plen = _clip_int(depth + (turns[s] + 1) * turn_tokens,
                         depth + 1, max_prompt)
        turns[s] += 1
        hard = rng.random() < guaranteed_fraction
        qos = QoSClass.GUARANTEED if hard else QoSClass.BURSTABLE
        raw.append((off, "chat", qos, service, plen, output_len,
                    f"fork{depth}-s{s}", slo_ms))
    knobs = {"rps": rps, "sessions": sessions,
             "header_tokens": header_tokens,
             "fork_depths": list(fork_depths),
             "turn_tokens": turn_tokens, "max_prompt": max_prompt,
             "output_len": output_len,
             "guaranteed_fraction": guaranteed_fraction, "slo_ms": slo_ms}
    return _finish("forked-chat", seed, duration_s, raw, services, knobs)


GENERATORS: Dict[str, Callable[..., Trace]] = {
    "diurnal-chat": diurnal_chat,
    "iot-burst": iot_burst,
    "longdoc-batch": longdoc_batch,
    "forked-chat": forked_chat,
}

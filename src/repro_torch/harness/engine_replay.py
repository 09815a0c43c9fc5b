"""Real-``ServingEngine`` fleet replay; the port of
``repro.harness.engine_replay``.

The replayer drives *simulated* services; this module replays traces
against an actual replicated engine fleet: ``run_fleet_replay`` stands
up an ``EdgeSystem``, deploys N replica ``ServingEngine``s through
``deploy_fleet``, and pumps a shared-prefix multi-turn trace through a
``FleetRouter`` via the replayer's ``submit_fn`` hook.  ``queue_s`` in
the outcomes is real — computed from the completed engine ``Request``'s
``submitted_at``/``admitted_at`` timestamps — and engine-stall chaos can
target ONE replica (``"svc/0"``), so the scorecard records the router's
rerouting/steal recovery instead of a fleet-wide freeze.

Prompts are deterministic per session: every prompt opens with a
fleet-wide system-prompt block (so even first turns share one affinity
block) followed by a per-session token stream whose prefix is stable as
turns grow — exactly the structure prefix-affinity routing exploits.
"""
from __future__ import annotations

import hashlib
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.manager import DispatchResult
from repro_torch.core.resources import NodeCapacity
from repro_torch.core.spec import QoSClass
from repro_torch.core.system import EdgeSystem
from repro_torch.core.workload import Workload, WorkloadClass, WorkloadKind
from repro_torch.fleet.router import FleetRouter
from repro_torch.harness.chaos import ChaosAction, ChaosInjector
from repro_torch.harness.replay import ReplayReport, TraceReplayer
from repro_torch.harness.scorecard import build_scorecard
from repro_torch.harness.trace import (Trace, TraceEvent, _clip_int,
                                       _finish, _thinned_poisson)
from repro_torch.serving.router import fleet_service_spec, make_fleet_builder

SYSTEM_BLOCK = 16           # fleet-wide shared system-prompt tokens


# --------------------------------------------------------------------------
# trace generation: shared-prefix burst + multi-turn sessions
# --------------------------------------------------------------------------

def fleet_trace(seed: int = 0, duration_s: float = 6.0,
                base_rps: float = 4.0, burst_rps: float = 9.0,
                sessions: int = 6, turn_tokens: int = 16,
                base_prompt: int = 32, max_prompt: int = 96,
                output_len: int = 6, guaranteed_every: int = 4,
                slo_ms: float = 2500.0, service: str = "fleet-chat"
                ) -> Trace:
    """Shared-prefix / multi-turn fleet trace.

    Arrivals follow a thinned Poisson with a mid-trace burst (the
    shared-prefix burst the fleet canary replays); each arrival is the
    next turn of one of ``sessions`` round-robin sessions, its prompt
    growing ``turn_tokens`` per turn (multi-turn history) from a common
    ``base_prompt``.  Every ``guaranteed_every``-th event is a
    GUARANTEED request from the pro tenant — the zero-drop invariant
    rides on those.
    """
    rng = np.random.default_rng(seed)
    lo, hi = duration_s / 3.0, 2.0 * duration_s / 3.0

    def rate(t: float) -> float:
        return burst_rps if lo <= t < hi else base_rps

    arrivals = _thinned_poisson(rng, duration_s, rate, burst_rps)
    turns: Dict[str, int] = {}
    raw = []
    for i, t in enumerate(arrivals):
        sess = f"fleet-s{i % sessions}"
        turn = turns.get(sess, 0)
        turns[sess] = turn + 1
        plen = _clip_int(base_prompt + turn * turn_tokens,
                         SYSTEM_BLOCK + 1, max_prompt)
        guaranteed = guaranteed_every > 0 and i % guaranteed_every == 0
        tenant = "fleet-pro" if guaranteed else "fleet-free"
        qos = QoSClass.GUARANTEED if guaranteed else QoSClass.BURSTABLE
        raw.append((t, tenant, qos, service, plen,
                    _clip_int(output_len, 1, 32), sess, slo_ms))
    services = {service: {"tenant": "fleet-free", "qos": "burstable",
                          "latency_slo_ms": slo_ms}}
    knobs = {"base_rps": base_rps, "burst_rps": burst_rps,
             "sessions": sessions, "turn_tokens": turn_tokens,
             "base_prompt": base_prompt, "max_prompt": max_prompt,
             "guaranteed_every": guaranteed_every}
    return _finish("fleet-chat", seed, duration_s, raw, services, knobs)


def session_tokens(session: str, length: int, vocab: int = 256
                   ) -> np.ndarray:
    """Deterministic per-session token stream with the prefix property:
    the first k tokens for length L are the first k for any L' >= k, so
    a growing multi-turn prompt shares its prefix with earlier turns."""
    h = hashlib.blake2b(session.encode("utf-8"), digest_size=8).digest()
    rng = np.random.default_rng(int.from_bytes(h, "big"))
    return rng.integers(1, vocab, size=max(length, 1), dtype=np.int32)


def make_engine_item(ev: TraceEvent, vocab: int = 256,
                     max_new_tokens: int = 16
                     ) -> Tuple[Workload, Tuple]:
    """Trace event → (workload, (tokens, request-meta)) for the fleet
    submit path.  Tokens = shared system block + session stream."""
    plen = max(ev.prompt_len, SYSTEM_BLOCK + 1)
    tokens = np.concatenate([
        session_tokens("fleet-system", SYSTEM_BLOCK, vocab),
        session_tokens(ev.session or f"solo-{ev.eid}",
                       plen - SYSTEM_BLOCK, vocab)])
    meta = {"session": ev.session,
            "guaranteed": ev.qos_class is QoSClass.GUARANTEED,
            "max_new": _clip_int(ev.output_len, 1, max_new_tokens),
            "slo_ms": ev.latency_slo_ms}
    workload = Workload(f"{ev.service}-{ev.eid}", WorkloadKind.GENERIC,
                        batch=1, seq_len=meta["max_new"],
                        est_flops=1e10, latency_slo_ms=ev.latency_slo_ms)
    return workload, (tokens, meta)


_FORK_RE = re.compile(r"^fork(\d+)-")


def make_forked_engine_item(ev: TraceEvent, vocab: int = 256,
                            max_new_tokens: int = 16
                            ) -> Tuple[Workload, Tuple]:
    """Trace event → engine item for ``trace.forked_chat`` traces.

    The session id encodes the fork depth (``fork{d}-s{n}``): tokens are
    the first ``d`` tokens of one shared header stream followed by the
    session's own stream — so two sessions with fork depths 16 and 32
    really are byte-identical for 16 tokens and the deeper one for 32,
    the divergent-prefix structure the radix/COW layer shares on."""
    m = _FORK_RE.match(ev.session or "")
    if m is None:
        return make_engine_item(ev, vocab, max_new_tokens)
    plen = ev.prompt_len
    depth = min(int(m.group(1)), max(plen - 1, 1))
    tokens = np.concatenate([
        session_tokens("forked-header", depth, vocab),
        session_tokens(ev.session, plen - depth, vocab)])
    meta = {"session": ev.session,
            "guaranteed": ev.qos_class is QoSClass.GUARANTEED,
            "max_new": _clip_int(ev.output_len, 1, max_new_tokens),
            "slo_ms": ev.latency_slo_ms}
    workload = Workload(f"{ev.service}-{ev.eid}", WorkloadKind.GENERIC,
                        batch=1, seq_len=meta["max_new"],
                        est_flops=1e10, latency_slo_ms=ev.latency_slo_ms)
    return workload, (tokens, meta)


def fleet_submit_fn(router: FleetRouter, result_timeout_s: float = 30.0):
    """Adapter: replayer item → router submit → DispatchResult-shaped
    result whose ``output`` is the completed engine ``Request`` (it
    carries ``submitted_at``/``admitted_at``, so the replayer's
    ``queue_s`` is measured from real engine timestamps)."""

    def submit(workload: Workload, args) -> DispatchResult:
        tokens, meta = args
        t0 = time.monotonic()
        handle = router.submit(tokens, max_new_tokens=meta["max_new"],
                               latency_slo_ms=meta["slo_ms"],
                               session=meta["session"],
                               guaranteed=meta["guaranteed"])
        req = handle.result(timeout=result_timeout_s)
        return DispatchResult(
            output=req, workload_class=WorkloadClass.HEAVY,
            executor_name="fleet-router", node_id="",
            wall_s=time.monotonic() - t0, deployed_fresh=False,
            service=router.service or "fleet")

    return submit


# --------------------------------------------------------------------------
# the scenario
# --------------------------------------------------------------------------

def run_fleet_replay(trace: Trace, cfg, *, replicas: int = 2,
                     nodes: Optional[int] = None, policy: str = "affinity",
                     speed: float = 1.0,
                     chaos_actions: Optional[List[ChaosAction]] = None,
                     max_slots: int = 4, max_seq: int = 128,
                     warmup: bool = True, drain_timeout_s: float = 90.0,
                     result_timeout_s: float = 30.0,
                     node_hbm_bytes: int = 8 << 30,
                     engine_kw: Optional[dict] = None,
                     router_kw: Optional[dict] = None,
                     device=None,
                     engine_sink: Optional[List] = None
                     ) -> Tuple[ReplayReport, FleetRouter, EdgeSystem]:
    """Replay ``trace`` against a real N-replica engine fleet.

    Builds the cluster (one replica per node by default, so node-loss
    chaos kills exactly one replica), deploys the fleet through the
    control plane (admission charges each replica), warms every replica
    up, and drives the trace through ``FleetRouter.submit``.  Callers
    own teardown: ``router.shutdown()`` when done with the engines.

    The engines are built on ``device`` (default: the card; the nodes'
    ``node_hbm_bytes`` is the caller's to size for it).  ``engine_kw``
    may carry ``params``, one tree every replica serves.  Every engine
    the fleet builder makes, failover's included, is appended to
    ``engine_sink`` when one is given.
    """
    service = next(iter(trace.meta.get("services", {"fleet-chat": {}})))
    system = EdgeSystem()
    for i in range(nodes if nodes is not None else replicas):
        system.add_node(f"edge{i}",
                        NodeCapacity(chips=1, hbm_bytes=node_hbm_bytes))
    build = make_fleet_builder(cfg, max_slots=max_slots, max_seq=max_seq,
                               device=device, **(engine_kw or {}))
    if engine_sink is not None:
        inner = build

        def build(workload, mesh):
            ex, footprint = inner(workload, mesh)
            engine_sink.append(ex.engine)
            return ex, footprint
    system.register_builder("generic", WorkloadClass.HEAVY, build)
    slo_ms = float(trace.meta.get("services", {}).get(service, {})
                   .get("latency_slo_ms", 0.0))
    spec = fleet_service_spec(cfg, name=service, replicas=replicas,
                              tenant="fleet-free",
                              latency_slo_ms=slo_ms)
    router = system.deploy_fleet(
        spec, policy=policy,
        **{"auto_rebalance_s": 0.25, **(router_kw or {})})
    if warmup:
        router.warmup()
    chaos = ChaosInjector(system, chaos_actions, speed=speed) \
        if chaos_actions else None
    # forked-chat traces need fork-aware token synthesis (the shared
    # header must really be byte-identical up to each session's depth)
    make_item = make_forked_engine_item \
        if trace.meta.get("generator") == "forked-chat" else make_engine_item
    replayer = TraceReplayer(
        system, trace, make_item=make_item, speed=speed,
        chaos=chaos, submit_fn=fleet_submit_fn(router, result_timeout_s),
        drain_timeout_s=drain_timeout_s)
    report = replayer.run()
    router.drain(timeout_s=5.0)
    return report, router, system


def fleet_scorecard(report: ReplayReport, router: FleetRouter) -> dict:
    """Scorecard with the fleet routing block attached: policy, per-
    replica submitted/completed/steals, affinity hit rate, reroutes."""
    return build_scorecard(report, extra={"fleet": router.stats()})

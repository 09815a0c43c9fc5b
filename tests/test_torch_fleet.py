"""The port's replicated engine fleet against the JAX package, on the CPU:

* the engine's probe surface, and the SLO autoscale of an engine-backed
  service reading the same admission-time queue samples as JAX's (the
  ROADMAP Queue C fault this pins);
* ``PrefixAffinityIndex`` (LRU, ``drop_replica``, longest match) fed the
  same calls in both packages;
* one scripted ``FleetRouter`` scenario driven through
  ``repro.fleet.FleetRouter`` and ``repro_torch.fleet.FleetRouter`` over
  the same plain-Python stub engines: every placement, counter and
  ``stats()`` equal;
* ``deploy_fleet`` on reduced fp32 tinyllama: admission charges as in
  JAX, a node loss healed by ``refresh()``, and every fleet request's
  greedy tokens equal to the JAX engine's for the same prompt;
* thread-safe kernel launch counters (two engine loops on one card).
"""
import itertools
import os
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fleet as jfleet
import repro.serving.engine as jengine_mod
import repro_torch.core as tcore
import repro_torch.fleet as tfleet
import repro_torch.serving.engine as tengine_mod
from repro.models.model import build_model as jax_build
from repro.serving import router as jrouter
from repro_torch.kernels import _WRAPPERS, build
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_numpy_tree
from repro_torch.serving import router as trouter

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _bridge(exact_config, seed=0):
    jcfg = exact_config("tinyllama-1.1b")
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jp = jax_build(jcfg).init(jax.random.key(seed))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def bridged(exact_config):
    return _bridge(exact_config)


# ---------------------------------------------------------------------------
# the engine's probe surface and the SLO autoscale (ROADMAP Queue C)
# ---------------------------------------------------------------------------

class _Clock:
    """A ``time`` module whose ``monotonic`` reads a settable clock, so a
    queue wait is set, not slept."""

    def __init__(self, now: float):
        self.now = now
        self.sleep = time.sleep

    def monotonic(self) -> float:
        return self.now


def _engine_service(pkg, router, cfg, params, **kw):
    system = pkg.EdgeSystem()
    system.add_node("n0", pkg.NodeCapacity(chips=1, hbm_bytes=8 << 30))
    system.register_builder(
        "generic", pkg.WorkloadClass.HEAVY,
        router.make_engine_builder(cfg, max_slots=2, max_seq=64,
                                   params=params, autostart=False, **kw))
    system.apply(router.fleet_service_spec(cfg, name="svc", replicas=1,
                                           latency_slo_ms=100.0))
    return system, system.instances("svc")[0].executor.engine


def test_queue_samples_and_slo_autoscale_match_jax(bridged, monkeypatch):
    """One 8-token prompt waits 0.3 s (a set clock), one ``step()`` admits
    it without finishing it: both engines sample the same wait, and
    ``autoscale(mode="slo")`` against a 100 ms SLO scales both services
    from 1 to 3 replicas (before the probe surface the port kept 1)."""
    jcfg, tcfg, jp, tp = bridged
    prompt = np.arange(1, 9, dtype=np.int32)
    got = {}
    for name, pkg, router, mod, cfg, params, kw in (
            ("jax", jcore, jrouter, jengine_mod, jcfg, jp, {}),
            ("torch", tcore, trouter, tengine_mod, tcfg, tp,
             {"device": "cpu"})):
        system, eng = _engine_service(pkg, router, cfg, params, **kw)
        clock = _Clock(100.0)
        monkeypatch.setattr(mod, "time", clock)
        eng.submit(prompt, max_new_tokens=4)
        clock.now = 100.3
        eng.step()
        monkeypatch.undo()
        assert len(eng.active) == 1 and not eng.completed
        assert eng.recent_queue_s.maxlen == 256
        got[name] = (eng.queue_samples(), eng.recent_queue_p95(),
                     eng.stats()["p95_queue_recent_s"],
                     system.autoscale("svc", mode="slo"),
                     len(system.instances("svc")))
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == [100.3 - 100.0] and got["jax"][3:] == (3, 3)


def test_probe_surface_matches_jax(bridged):
    """``queue_depth``, ``load``, ``cancel_queued``, ``note_prefix`` and
    the stats keys the router reads agree with the JAX engine's on the
    same queue; ``responsive`` times out while another thread holds the
    engine lock (the chaos stall) and the port's ``handle.future`` is the
    request's."""
    jcfg, tcfg, jp, tp = bridged
    views = {}
    for name, eng in (
            ("jax", jengine_mod.ServingEngine(jcfg, max_slots=2, max_seq=64,
                                              params=jp, replica_id="f/0")),
            ("torch", tengine_mod.ServingEngine(tcfg, max_slots=2,
                                                max_seq=64, params=tp,
                                                replica_id="f/0",
                                                device="cpu"))):
        hs = [eng.submit(np.arange(1, 4 + 9 * i, dtype=np.int32) % 200 + 1,
                         max_new_tokens=3) for i in range(4)]
        with eng._lock:
            eng._admit()                     # 2 slots: two stay queued
        cancelled = eng.cancel_queued(hs[3].rid)
        eng.note_prefix(True)
        eng.note_prefix(False)
        eng.note_prefix(True)
        st = eng.stats()
        views[name] = (
            eng.queue_depth(), eng.load(), cancelled.rid,
            cancelled.phase, eng.cancel_queued(hs[0].rid),
            [eng.estimate_marginal_pages(np.arange(n)) for n in (1, 16, 40)],
            {k: st[k] for k in ("queue_depth", "replica_id", "prefix_hits",
                                "prefix_misses", "prefix_hit_rate")})
        if name == "torch":
            assert hs[0].future is hs[0]._req.future
            held, release = threading.Event(), threading.Event()

            def stall():
                with eng._lock:
                    held.set()
                    release.wait(timeout=10.0)
            t = threading.Thread(target=stall, daemon=True)
            t.start()
            assert held.wait(timeout=10.0)
            try:
                assert eng.responsive(timeout=0.05) is False
                assert eng.cancel_queued(hs[2].rid, timeout=0.05) is None
            finally:
                release.set()
                t.join(timeout=10.0)
            assert eng.responsive(timeout=1.0) is True
    assert views["torch"] == views["jax"]
    assert views["jax"][0] == 1 and views["jax"][4] is None


def test_marginal_pages_drop_on_a_warm_radix(bridged):
    """A served prompt's pages go to the radix, so the same prefix costs
    fewer marginal pages (the router's least-pages tie-break), and each
    finished request's dispatch sample carries the replica id."""
    _, tcfg, _, tp = bridged
    eng = tengine_mod.ServingEngine(tcfg, max_slots=2, max_seq=64,
                                    params=tp, replica_id="f/1",
                                    device="cpu")
    prompt = (np.arange(40, dtype=np.int32) % 200) + 1
    cold = eng.estimate_marginal_pages(prompt)
    eng.submit(prompt, max_new_tokens=2).result(timeout=60)
    assert eng.estimate_marginal_pages(prompt) < cold
    assert [s.replica for s in eng.dispatch_stats.samples] == ["f/1"]


# ---------------------------------------------------------------------------
# the affinity index
# ---------------------------------------------------------------------------

def test_affinity_index_matches_jax():
    """LRU order, eviction, ``drop_replica`` and longest-prefix lookups on
    the same call sequence, block 4 and capacity 6."""
    rng = np.random.default_rng(0)
    heads = [rng.integers(0, 50, size=24).astype(np.int32)
             for _ in range(3)]
    calls = []
    for i in range(40):
        toks = heads[i % 3][:int(rng.integers(1, 25))].copy()
        if rng.random() < 0.2:
            toks[int(rng.integers(len(toks)))] += 1
        kind = ("record", "lookup", "drop")[int(rng.integers(3))] \
            if i % 7 else "drop"
        calls.append((kind, toks, f"e{int(rng.integers(3))}"))
    out = {}
    for name, pkg in (("jax", jfleet), ("torch", tfleet)):
        idx = pkg.PrefixAffinityIndex(block=4, capacity=6)
        trace = []
        for kind, toks, rep in calls:
            if kind == "record":
                trace.append(idx.record(toks, rep))
            elif kind == "lookup":
                trace.append(idx.lookup(toks))
            else:
                trace.append(idx.drop_replica(rep))
            trace.append((len(idx), list(idx._map.items())))
        with pytest.raises(ValueError):
            pkg.PrefixAffinityIndex(block=0)
        out[name] = trace
    assert out["torch"] == out["jax"]
    hits = [t[1] for (kind, _, _), t in zip(calls, out["jax"][::2])
            if kind == "lookup"]
    assert max(hits) > 1 and 0 in hits      # long matches and misses


# ---------------------------------------------------------------------------
# one scripted router scenario through both packages
# ---------------------------------------------------------------------------

class StubHandle:
    def __init__(self, rid, future):
        self.rid = rid
        self.future = future


class StubEngine:
    """Engine-shaped stub: submissions queue as futures the scenario
    resolves explicitly, so every routing decision is deterministic."""

    def __init__(self):
        self.replica_id = ""
        self.kv_bytes = 0
        self.ok = True
        self.fail_submit = False
        self.queued = {}
        self.active = 0
        self.notes = []
        self.qos = []
        self._rids = itertools.count()

    def submit(self, prompt, max_new_tokens=16, eos_token=None,
               latency_slo_ms=0.0, qos="burstable"):
        if self.fail_submit:
            raise RuntimeError("engine refused")
        self.qos.append(qos)
        rid = next(self._rids)
        fut = Future()
        self.queued[rid] = fut
        return StubHandle(rid, fut)

    def finish(self, rid=None, result="done"):
        rid = rid if rid is not None else next(iter(self.queued))
        self.queued.pop(rid).set_result(result)

    def load(self):
        return (len(self.queued), self.active, self.kv_bytes)

    def queue_depth(self):
        return len(self.queued)

    def responsive(self, timeout=0.05):
        return self.ok

    def cancel_queued(self, rid, timeout=0.1):
        return self.queued.pop(rid, None)

    def note_prefix(self, hit):
        self.notes.append(hit)

    def recent_queue_p95(self):
        return 0.0


P0 = np.arange(32, dtype=np.int32)


def _router_scenario(FleetRouter) -> list:
    """The JAX package's router tests as one script: returns every
    placement, counter set, stats rollup and stub observation."""
    log = []

    def fleet(policy="affinity", **kw):
        engines = [StubEngine(), StubEngine()]
        return FleetRouter(engines, policy=policy, **kw), engines

    def snap(tag, router, engines):
        st = router.stats()
        log.append((f"snap-{tag}", dict(router.counters), st,
                    [(e.replica_id, e.queue_depth(), e.notes, e.qos)
                     for e in engines]))

    # prefix affinity: a cold miss, a hit on the recorded prefix, a miss
    r, es = fleet()
    h = r.submit(P0)
    es[int(h._rec.replica[-1])].finish()
    log.append(("result", h.result(timeout=5.0)))
    h2 = r.submit(np.concatenate([P0, P0 + 100]))
    h3 = r.submit(np.arange(200, 232, dtype=np.int32))
    log.append(("affinity", h._rec.replica, h2._rec.replica,
                h3._rec.replica))
    snap("affinity", r, es)

    # session stickiness beats least load
    r, es = fleet()
    h = r.submit(P0, session="s1")
    pinned = es[int(h._rec.replica[-1])]
    for _ in range(4):
        pinned.submit(P0)
    h2 = r.submit(np.arange(500, 532, dtype=np.int32), session="s1")
    log.append(("sticky", h._rec.replica, h2._rec.replica))
    snap("sticky", r, es)

    # least pages breaks a tie of equal depth
    r, es = fleet()
    es[0].kv_bytes, es[1].kv_bytes = 1 << 20, 1 << 10
    log.append(("least-pages",
                r.submit(np.arange(900, 932, dtype=np.int32))._rec.replica))
    snap("least-pages", r, es)

    # round-robin rotates blindly and records no affinity
    r, es = fleet(policy="round-robin")
    log.append(("rr", [r.submit(P0, session="s")._rec.replica
                       for _ in range(4)], len(r._affinity)))
    snap("rr", r, es)

    # stall evasion
    r, es = fleet()
    h = r.submit(P0, session="s1")
    es[int(h._rec.replica[-1])].ok = False
    h2 = r.submit(P0, session="s1")
    log.append(("evade", h._rec.replica, h2._rec.replica))
    snap("evade", r, es)

    # the steal threshold and the median floor, then no ping-pong back
    r, es = fleet()
    for _ in range(6):
        r.submit(P0, session="hot")
    log.append(("steal", r.rebalance(), r.rebalance(),
                [e.queue_depth() for e in es]))
    snap("steal", r, es)
    r, es = fleet()
    r.submit(P0, session="a")
    r.submit(P0, session="a")
    log.append(("steal-noop", r.rebalance()))

    # a GUARANTEED failure reroutes; a BURSTABLE one fails
    r, es = fleet()
    h = r.submit(P0, session="s1")
    bad = es[int(h._rec.replica[-1])]
    good = es[1 - int(h._rec.replica[-1])]
    bad.finish()
    h.result(timeout=5.0)
    bad.fail_submit = True
    hg = r.submit(P0, session="s1", guaranteed=True)
    r.poke()
    good.finish(hg._rec.inner.rid)
    log.append(("reroute", hg._rec.replica, hg.result(timeout=5.0)))
    hb = r.submit(P0, session="s1")
    with pytest.raises(RuntimeError, match="engine refused"):
        hb.result(timeout=5.0)
    snap("reroute", r, es)

    # replica loss reroutes GUARANTEED work; the orphan may still finish
    r, es = fleet()
    hg = r.submit(P0, session="s1", guaranteed=True)
    hb = r.submit(P0, session="s1")
    lost_key = hg._rec.replica
    lost, survivor = es[int(lost_key[-1])], es[1 - int(lost_key[-1])]
    moved = r.mark_replica_lost(lost_key)
    survivor.finish(hg._rec.inner.rid)
    h2 = r.submit(P0, session="s1")
    lost.finish(hb._rec.inner.rid)
    log.append(("loss", moved, hg._rec.replica, hg.result(timeout=5.0),
                h2._rec.replica, hb.result(timeout=5.0)))
    snap("loss", r, es)
    return log


def test_scripted_router_scenario_matches_jax():
    want = _router_scenario(jfleet.FleetRouter)
    got = _router_scenario(tfleet.FleetRouter)
    assert got == want
    tags = {e[0]: e[1:] for e in want if not e[0].startswith("snap-")}
    assert tags["affinity"][0] == tags["affinity"][1]    # the prefix hit
    assert tags["sticky"][0] == tags["sticky"][1]
    assert tags["least-pages"] == ("replica/1",)
    assert tags["evade"][0] != tags["evade"][1]
    assert tags["rr"] == (["replica/0", "replica/1"] * 2, 0)
    assert tags["steal"][0] == {"moved": 3, "median_depth": 3.0}
    assert tags["loss"][0] == 1


# ---------------------------------------------------------------------------
# deploy_fleet on real engines
# ---------------------------------------------------------------------------

PROMPTS = [(np.arange(12 + 5 * i, dtype=np.int32) * (i + 3)) % 250 + 1
           for i in range(4)]


def _fleet(pkg, router, cfg, params, **kw):
    system = pkg.EdgeSystem()
    for i in range(2):
        system.add_node(f"edge{i}",
                        pkg.NodeCapacity(chips=1, hbm_bytes=8 << 30))
    system.register_builder(
        "generic", pkg.WorkloadClass.HEAVY,
        router.make_fleet_builder(cfg, max_slots=2, max_seq=64,
                                  params=params, **kw))
    spec = router.fleet_service_spec(cfg, name="fleet-it", replicas=2,
                                     tenant="pro")
    return system, system.deploy_fleet(spec)


def test_deploy_fleet_admission_failover_and_tokens_match_jax(bridged):
    """Both packages charge the same two replicas on two nodes; the port's
    fleet serves four prompts (sessions, one GUARANTEED), survives a node
    loss (``refresh()`` swaps the rebuilt engine in) and serves again, and
    every request's greedy tokens equal one JAX engine's."""
    jcfg, tcfg, jp, tp = bridged
    jeng = jengine_mod.ServingEngine(jcfg, max_slots=2, max_seq=64,
                                     params=jp)
    jh = [jeng.submit(p, max_new_tokens=4) for p in PROMPTS]
    jeng.run_until_drained()
    want = [list(h.result().generated) for h in jh]

    jsys, jr = _fleet(jcore, jrouter, jcfg, jp)
    try:
        jcharged = jsys.admission.instance_commitments()
    finally:
        jr.shutdown()
    tsys, tr = _fleet(tcore, trouter, tcfg, tp, device="cpu")
    try:
        charged = tsys.admission.instance_commitments()
        assert charged == jcharged
        assert len(charged) == 2 and \
            len({v["node"] for v in charged.values()}) == 2
        assert all(v["hbm_bytes"] > 0 and v["tenant"] == "pro"
                   for v in charged.values())
        hs = [tr.submit(p, max_new_tokens=4, session=f"s{i % 2}",
                        guaranteed=i == 0) for i, p in enumerate(PROMPTS)]
        got = [list(h.result(timeout=120.0).generated) for h in hs]
        assert got == want
        before = {k: id(d.executor.engine)
                  for k, d in ((d.name, d) for d in
                               tsys.instances("fleet-it"))}
        victim = tsys.instances("fleet-it")[0]
        tsys.on_node_loss(victim.node_id)
        tr.refresh()
        st = tr.stats()
        assert sum(d["alive"] for d in st["replicas"].values()) == 2
        rebuilt = tsys.orchestrator.deployments[victim.name].executor.engine
        assert id(rebuilt) != before[victim.name]
        assert tr._replicas[victim.name].engine is rebuilt
        assert rebuilt.replica_id == victim.name and rebuilt.loop_running
        hs = [tr.submit(p, max_new_tokens=4, session=f"s{i % 2}",
                        guaranteed=True) for i, p in enumerate(PROMPTS)]
        assert [list(h.result(timeout=120.0).generated) for h in hs] == want
        assert tr.drain(timeout_s=30.0)
        st = tr.stats()
        assert st["completed"] == st["submitted"] == 8 and st["failed"] == 0
    finally:
        tr.shutdown()


# ---------------------------------------------------------------------------
# launch counters and the port's isolation
# ---------------------------------------------------------------------------

def test_launch_counters_are_thread_safe(monkeypatch):
    """More threads than cores counting launches of one wrapper lose no
    count, and every wrapper counts through ``build.count_launch``: an
    attribute's ``+= 1`` is a load, an add and a store, which only the
    interpreter's choice of switch points keeps together; the lock does
    not depend on it."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    n_threads, each = (os.cpu_count() or 1) + 2, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(n_threads)

        def count():
            start.wait(timeout=30.0)
            for _ in range(each):
                build.count_launch(fa.flash_attention)
        ts = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert fa.flash_attention.launches == n_threads * each
    kdir = ROOT / "src" / "repro_torch" / "kernels"
    for mod, fn in _WRAPPERS.values():
        text = (kdir / f"{mod}.py").read_text()
        assert f"build.count_launch({fn})" in text, (mod, fn)
        assert ".launches += 1" not in text, mod


def test_fleet_and_harness_import_no_jax():
    """The new ``fleet/`` and ``harness/`` modules import neither JAX nor
    the JAX package, by text (``tests/test_torch_isolation.py`` checks
    every port module's imports by AST)."""
    files = sorted((ROOT / "src" / "repro_torch" / "fleet").glob("*.py")) + \
        sorted((ROOT / "src" / "repro_torch" / "harness").glob("*.py"))
    assert len(files) >= 10
    for f in files:
        for line in f.read_text().splitlines():
            code = line.split("#")[0].strip()
            assert not code.startswith(("import jax", "from jax",
                                        "import repro.", "from repro.",
                                        "from repro import")), \
                (f.name, line)

"""The port's trace/chaos harness against the JAX package, on the CPU:

* every trace generator (the four of ``GENERATORS`` and ``fleet_trace``)
  gives the JAX generator's JSONL and ``fingerprint()`` for the same seed
  and knobs, and ``chip_smoke.py``'s fleet trace fingerprint is JAX's;
* ``build_scorecard``, ``diff_scorecards`` and ``jain_index`` give JAX's
  results on one synthetic ``RequestOutcome`` list;
* sim replays on the port's ``EdgeSystem``: node-loss chaos keeps the
  GUARANTEED invariant, quota churn and a stall are recorded;
* an engine stall holds the port engine's lock;
* a short ``run_fleet_replay`` over two reduced fp32 tinyllama replicas,
  under affinity, round-robin and chaos (a stall and a node loss).
"""
import dataclasses
import importlib.util
import json
import math
import threading
from pathlib import Path

import pytest
import torch

import repro.harness as jh
import repro.harness.scorecard as jscore
import repro_torch.harness as th
import repro_torch.harness.scorecard as tscore
from repro_torch.configs import get_reduced_config
from repro_torch.core import (EdgeSystem, NodeCapacity, WorkloadClass)
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

GEN_CASES = [
    ("diurnal-chat", {"seed": 7, "duration_s": 8.0}),
    ("diurnal-chat", {"seed": 1, "duration_s": 20.0, "day_s": 10.0,
                      "continue_p": 0.9}),
    ("iot-burst", {"seed": 7, "duration_s": 8.0, "burst_period_s": 3.0,
                   "alarm_rps": 1.0}),
    ("longdoc-batch", {"seed": 3, "duration_s": 12.0,
                       "batch_period_s": 3.0}),
    ("forked-chat", {"seed": 5, "fork_depths": (8, 24, 40)}),
    ("fleet-chat", {}),
    ("fleet-chat", {"seed": 2, "duration_s": 3.0, "sessions": 3,
                    "guaranteed_every": 3}),
]


def _gen(pkg, name):
    return pkg.fleet_trace if name == "fleet-chat" else pkg.GENERATORS[name]


@pytest.mark.parametrize("name,knobs", GEN_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GEN_CASES)])
def test_generator_matches_jax(name, knobs):
    want = _gen(jh, name)(**knobs)
    got = _gen(th, name)(**knobs)
    assert len(got) > 0
    assert got.to_jsonl() == want.to_jsonl()           # byte for byte
    assert got.fingerprint() == want.fingerprint()
    back = th.Trace.from_jsonl(got.to_jsonl())
    assert back == got and back.fingerprint() == got.fingerprint()


def test_chip_smoke_fleet_trace_fingerprint_is_jax():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FLEET_TRACE_FINGERPRINT == jh.fleet_trace().fingerprint()


def test_trace_event_validation_and_load(tmp_path):
    for bad in ({"qos": "platinum"}, {"offset_s": -1.0},
                {"prompt_len": 0}):
        kw = dict(eid=0, offset_s=0.0, tenant="t", qos="guaranteed",
                  service="s", prompt_len=4, output_len=4)
        kw.update(bad)
        with pytest.raises(ValueError):
            th.TraceEvent(**kw)
    t = th.iot_burst(seed=0, duration_s=4.0, burst_period_s=2.0)
    path = tmp_path / "t.jsonl"
    t.dump(str(path))
    assert th.Trace.load(str(path)) == t
    with pytest.raises(ValueError):
        th.Trace.from_jsonl("")


# ---------------------------------------------------------------------------
# scorecards
# ---------------------------------------------------------------------------

def _outcomes(pkg):
    rows = [
        (0, "svc", "a", "guaranteed", 0.0, 0.001, 0.20, 0.18, 0.01, "ok",
         0, 250.0, ""),
        (1, "svc", "a", "guaranteed", 0.1, 0.002, 0.40, 0.35, 0.02, "ok",
         1, 250.0, ""),
        (2, "svc", "b", "burstable", 0.2, 0.0, 0.10, 0.09, 0.0, "ok", 0,
         0.0, ""),
        (3, "svc", "b", "burstable", 0.3, 0.003, math.inf, math.nan, 0.0,
         "refused", 0, 600.0, "quota"),
        (4, "alerts", "c", "guaranteed", 0.4, math.nan, math.inf,
         math.nan, 0.0, "timeout", 0, 250.0, "hung"),
        (5, "alerts", "c", "guaranteed", 0.5, 0.001, math.inf, 0.5, 0.0,
         "failed", 2, 250.0, "boom"),
        (6, "svc", "a", "burstable", 0.6, 0.0, 0.30, 0.25, 0.03, "ok", 0,
         800.0, ""),
    ]
    outcomes = [pkg.RequestOutcome(*r) for r in rows]
    chaos = [pkg.ChaosRecord("node-loss", "edge1", 1.0, 1.01, 0.2,
                             {"moved": 1, "failover_failed": 0})]
    events = ["deploy svc/0 -> edge0", "failover svc/1 edge1->edge0",
              "failover-FAILED svc/2", "preempt x", "reconcile svc/3"]
    return pkg.ReplayReport("t", 0, 2.0, 2.0, 1.5, outcomes, events, chaos)


def test_scorecard_diff_and_jain_match_jax():
    cards = {}
    for name, pkg, score in (("jax", jh, jscore), ("torch", th, tscore)):
        card = score.build_scorecard(_outcomes(pkg), extra={"x": 1})
        old = {"version": 1, "scenarios": {"a": card, "gone": card}}
        new = {"version": 1, "scenarios": {
            "a": dict(card, slo={"attainment": 0.1},
                      latency={"p95_s": 9.0},
                      guaranteed={"dropped": 3}),
            "fresh": card}}
        cards[name] = (
            json.dumps(card, sort_keys=True),
            score.diff_scorecards(old, new),
            score.diff_scorecards(old, old),
            [repr(score.jain_index(v)) for v in
             ([1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [4.0, 1.0], [],
              [math.inf, 2.0])])
    assert cards["torch"] == cards["jax"]
    card = json.loads(cards["jax"][0])
    assert card["guaranteed"] == {"total": 4, "completed": 2,
                                  "requeued": 2, "failed_after_requeue": 1,
                                  "dropped": 1}
    assert len(cards["jax"][1]) == 3 and cards["jax"][2] == []


def test_scorecard_write_load_and_cli(tmp_path, capsys):
    path = str(tmp_path / "sub" / "cards.json")
    th.write_scorecards({"s1": {"trace": "t1"}}, path=path)
    th.write_scorecards({"s2": {"trace": "t2"}}, path=path)
    assert set(th.load_scorecards(path)["scenarios"]) == {"s1", "s2"}
    assert tscore.DEFAULT_PATH == str(Path("build") / "port_traces.json")
    old_p, new_p = str(tmp_path / "old.json"), str(tmp_path / "new.json")
    card = {"slo": {"attainment": 1.0}, "latency": {"p95_s": 0.002},
            "guaranteed": {"dropped": 0}}
    th.write_scorecards({"a": card}, path=old_p)
    th.write_scorecards({"a": card}, path=new_p)
    assert tscore.main(["--old", old_p, "--new", new_p]) == 0
    th.write_scorecards({"a": dict(card, slo={"attainment": 0.5})},
                        path=new_p)
    assert tscore.main(["--old", old_p, "--new", new_p]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# sim replays with chaos
# ---------------------------------------------------------------------------

def _tiny_system(trace, nodes=3, replicas=2):
    system = EdgeSystem()
    for i in range(nodes):
        system.add_node(f"edge{i}", NodeCapacity(chips=1,
                                                 hbm_bytes=64 << 20))
    system.register_builder("generic", WorkloadClass.HEAVY,
                            th.sim_builder(base_s=1e-4, per_token_s=1e-6))
    for spec in th.specs_for_trace(trace, replicas=replicas):
        system.apply(spec)
    return system


def test_sim_replay_node_loss_keeps_the_guaranteed_invariant():
    trace = th.iot_burst(seed=2, duration_s=4.0, burst_period_s=1.5,
                         burst_size=10, alarm_rps=2.0)
    system = _tiny_system(trace)
    chaos = th.ChaosInjector(system, [
        th.ChaosAction(at_s=1.5, kind="node-loss", target="edge1"),
        th.ChaosAction(at_s=3.0, kind="node-rejoin", target="edge1"),
    ], speed=4.0)
    report = th.TraceReplayer(system, trace, speed=4.0, chaos=chaos).run()
    card = th.build_scorecard(report)
    assert [r.kind for r in report.chaos] == ["node-loss", "node-rejoin"]
    assert all(r.fired_at_s >= 0 and not r.details.get("error")
               for r in report.chaos)
    assert report.chaos[0].details["moved"] > 0
    g = card["guaranteed"]
    assert g["total"] > 0 and g["dropped"] == 0, g
    assert all(o.ok or o.requeues > 0 for o in report.outcomes
               if o.qos == "guaranteed")
    assert card["requests"]["total"] == len(trace)
    assert card["events"]["failover"] > 0
    assert set(card["per_tenant"]) == {e.tenant for e in trace.events}


def test_sim_replay_quota_churn_and_stall_records():
    trace = th.iot_burst(seed=4, duration_s=2.0, burst_period_s=1.0,
                         burst_size=4, alarm_rps=1.0)
    system = _tiny_system(trace)
    chaos = th.ChaosInjector(system, [
        th.ChaosAction(at_s=0.5, kind="quota-set", target="sensors",
                       flops_inflight=5e10),
        th.ChaosAction(at_s=1.0, kind="engine-stall", target="telemetry",
                       duration_s=0.4),
        th.ChaosAction(at_s=1.5, kind="quota-clear", target="sensors"),
    ], speed=4.0)
    report = th.TraceReplayer(system, trace, speed=4.0, chaos=chaos).run()
    assert [r.kind for r in report.chaos] == ["quota-set", "engine-stall",
                                               "quota-clear"]
    assert all(not r.details.get("error") for r in report.chaos)
    assert report.chaos[1].details["stalled"] == 2
    assert th.build_scorecard(report)["guaranteed"]["dropped"] == 0
    with pytest.raises(ValueError):
        th.ChaosAction(at_s=0.0, kind="meteor-strike")


def test_engine_stall_holds_the_port_engine_lock():
    """The injector's engine stall takes the port engine's ``_lock`` from
    its own thread: ``responsive()`` times out until the stall ends."""
    cfg = get_reduced_config("tinyllama-1.1b")
    eng = ServingEngine(cfg, max_slots=2, max_seq=32, device="cpu")

    class Dep:                               # a deployment of the engine
        name = "svc/0"
        executor = type("Ex", (), {"engine": eng})()

    class System:
        def instances(self, target):
            return [Dep()] if target == "svc" else []

    inj = th.ChaosInjector(System(), [], speed=1.0)
    rec = inj.fire(th.ChaosAction(at_s=0.0, kind="engine-stall",
                                  target="svc", duration_s=0.5), 0.0)
    assert rec.details == {"stalled": 1, "instances": ["svc/0"],
                           "wall_s": 0.5}
    assert eng.responsive(timeout=0.05) is False
    inj.join(timeout=10.0)
    assert eng.responsive(timeout=1.0) is True


# ---------------------------------------------------------------------------
# the fleet replay on real engines
# ---------------------------------------------------------------------------

def test_run_fleet_replay_reduced_cpu():
    """Two reduced fp32 tinyllama replicas replay one fleet trace three
    times: affinity, round-robin, and affinity under a stall of replica 0
    and the loss of node edge1 (failover builds a third engine, which
    the router swaps in).  Every request completes or is requeued, no
    GUARANTEED request is dropped, affinity's hit rate is above
    round-robin's and the scorecard carries the fleet block."""
    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    trace = th.fleet_trace(seed=0, duration_s=2.0, base_rps=4.0,
                           burst_rps=8.0, sessions=3, base_prompt=24,
                           max_prompt=56, output_len=4)
    chaos = [th.ChaosAction(at_s=0.4, kind="engine-stall",
                            target="fleet-chat/0", duration_s=0.4),
             th.ChaosAction(at_s=1.0, kind="node-loss", target="edge1"),
             th.ChaosAction(at_s=1.9, kind="node-rejoin", target="edge1")]
    runs = {}
    for name, policy, actions in (("affinity", "affinity", None),
                                  ("round-robin", "round-robin", None),
                                  ("chaos", "affinity", chaos)):
        built = []
        report, router, system = th.run_fleet_replay(
            trace, cfg, policy=policy, chaos_actions=actions,
            max_slots=2, max_seq=64, device="cpu", engine_sink=built,
            drain_timeout_s=60.0, result_timeout_s=30.0)
        try:
            card = th.fleet_scorecard(report, router)
        finally:
            router.shutdown()
        runs[name] = (report, card, built)
        assert card["requests"]["total"] == len(trace)
        assert all(o.ok or o.requeues > 0 for o in report.outcomes), \
            [o for o in report.outcomes if not o.ok]
        assert card["guaranteed"]["dropped"] == 0
        assert card["fleet"]["policy"] == policy
        assert all(e.device.type == "cpu" for e in built)
        served = sum(len(e.completed) for e in built)
        assert served >= card["requests"]["completed"]
    assert runs["affinity"][1]["fleet"]["affinity_hit_rate"] > \
        runs["round-robin"][1]["fleet"]["affinity_hit_rate"]
    report, card, built = runs["chaos"]
    assert [r.kind for r in report.chaos] == ["engine-stall", "node-loss",
                                               "node-rejoin"]
    assert report.chaos[0].details["instances"] == ["fleet-chat/0"]
    assert report.chaos[1].details == {"moved": 1, "failover_failed": 0}
    assert len(built) == 3                   # failover built a third engine
    assert card["events"]["failover"] == 1
    assert [len(r[2]) for r in (runs["affinity"], runs["round-robin"])] \
        == [2, 2]
    assert all(t.name != "chaos-stall-fleet-chat/0" or not t.is_alive()
               for t in threading.enumerate())

"""The port's control plane (``repro_torch.core``) against ``repro.core``.

One scripted scenario runs against both packages with the same
pure-Python stub executors and footprints: apply and scale, tenant
quotas, QoS preemption and the pending redeploys it queues, the weighted
dispatch order of ``submit_many``, a per-dispatch FLOP-quota refusal,
queue autoscale, node loss and rejoin.  Both must make the same
placements, orchestrator events, admission decisions and evictions, the
same dispatch order, ``report()`` keys and counts, and the same saved
state.  Every dispatch runs serially (``concurrent=False``), so nothing
here depends on thread timing.  A state file written by the JAX
``EdgeSystem`` restores into the port's.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore

torch.set_num_threads(1)

FOOTPRINT = {"svc-a": 30, "be": 50, "be2": 50, "gold": 80, "t3": 10}


def _stub_class(core):
    """A pure-Python executor of ``core``'s ``BaseExecutor``: accepts only
    workloads whose name starts with its service's, logs every dispatch."""

    class Stub(core.BaseExecutor):
        executor_class = core.ExecutorClass.CONTAINER

        def __init__(self, name, service, log, mesh=None):
            super().__init__(name, mesh)
            self.service = service
            self.log = log

        def footprint_bytes(self):
            return FOOTPRINT[self.service]

        def can_run(self, workload, args):
            return workload.name.startswith(self.service)

        def dispatch(self, workload, args):
            self.log.append((self.name, workload.name))
            self.history.append(core.executor.DispatchRecord(
                workload.name, 0.0, False))
            return (self.name, workload.name)

    return Stub


def _system(core, log, n_nodes=3, hbm=100):
    Stub = _stub_class(core)
    counter = itertools.count()
    system = core.EdgeSystem(policy=core.LeastLoadedPolicy())
    for i in range(n_nodes):
        system.add_node(f"n{i}", core.NodeCapacity(chips=1, hbm_bytes=hbm,
                                                   flops_per_s=1.0))

    def builder(workload, mesh):
        ex = Stub(f"stub[{workload.name}]{next(counter)}", workload.name,
                  log, mesh=mesh)
        return ex, ex.footprint_bytes()

    system.register_builder("generic", core.WorkloadClass.HEAVY, builder)
    return system


def _spec(core, name, replicas=1, tenant="t1", qos="burstable", priority=0,
          hint=True):
    return core.ServiceSpec(
        name=name, workload=core.Workload(name, core.WorkloadKind.GENERIC),
        executor_class=core.ExecutorClass.CONTAINER, replicas=replicas,
        footprint_hint=FOOTPRINT[name] if hint else None, tenant=tenant,
        qos=core.QoSClass(qos), priority=priority)


def _placements(system):
    return sorted((d.name, d.node_id, d.footprint)
                  for d in system.orchestrator.deployments.values())


def _decisions(system):
    return [dataclasses.asdict(d) for d in system.admission.decisions]


def _report_view(rep):
    """``report()`` without the wall-clock numbers: its keys, the sample
    counts per class and executor class, and every deterministic block."""
    view = {"keys": sorted(rep)}
    for wc in ("heavy", "light"):
        view[wc] = {k: rep[wc].get(k) for k in ("count", "cold_count",
                                                "warm_count",
                                                "mean_footprint_bytes")}
        view[f"{wc}_keys"] = sorted(rep[wc])
    for key in ("executors", "backups", "services", "queue", "registry",
                "nodes"):
        view[key] = rep[key]
    view["tenant_usage"] = rep["tenants"]["usage"]
    view["tenant_latency_counts"] = {
        t: s["count"] for t, s in rep["tenants"]["latency"].items()}
    return view


def _scenario(core, tmp_path):
    log, rec = [], {}
    system = _system(core, log)
    evicted = []
    system.on_eviction(lambda *a: evicted.append(a))

    # apply, then scale
    system.apply(_spec(core, "svc-a", replicas=2))
    rec["scale"] = system.scale("svc-a", 3)
    rec["after_scale"] = _placements(system)

    # tenant quota: t2 may hold 60 bytes, so a second 50-byte
    # BEST_EFFORT service is refused for the tenant, not the node
    system.set_tenant_quota("t2", hbm_bytes=60)
    system.apply(_spec(core, "be", tenant="t2", qos="best-effort"))
    with pytest.raises(core.PlacementError) as e:
        system.apply(_spec(core, "be2", tenant="t2", qos="best-effort"))
    rec["quota_refusal"] = str(e.value)
    rec["after_quota"] = _placements(system)

    # QoS preemption: 80 bytes fit nowhere outright; GUARANTEED evicts the
    # BEST_EFFORT instance and then a BURSTABLE one, which both queue
    system.apply(_spec(core, "gold", tenant="t9", qos="guaranteed",
                       priority=5, hint=False))
    rec["after_preempt"] = _placements(system)
    rec["pending"] = list(system.pending_redeploys)
    rec["evicted"] = list(evicted)
    # freeing capacity drains the pending redeploys
    system.scale("gold", 0)
    rec["after_drain"] = _placements(system)
    rec["pending_after"] = list(system.pending_redeploys)

    # weighted deficit round-robin inside one QoS level, QoS order across
    # levels, and a per-dispatch FLOP-quota refusal at its position
    system.apply(_spec(core, "t3", tenant="t3"))
    system.set_tenant_weight("t1", 2.0)
    system.set_tenant_quota("t3", flops_inflight=5.0)
    items = [(core.Workload(f"{svc}-{i}", core.WorkloadKind.GENERIC,
                            est_flops=float(f)), ())
             for svc, i, f in [("t3", 0, 1), ("t3", 1, 9), ("t3", 2, 1),
                               ("svc-a", 0, 1), ("svc-a", 1, 1),
                               ("svc-a", 2, 1), ("be", 0, 1),
                               ("svc-a", 3, 1)]]
    system.scale("gold", 1)                  # a GUARANTEED level again
    items.append((core.Workload("gold-0", core.WorkloadKind.GENERIC), ()))
    log.clear()
    out = system.submit_many(items, concurrent=False, speculative=False,
                             return_exceptions=True)
    rec["dispatch_order"] = list(log)
    rec["results"] = [type(r).__name__ if isinstance(r, Exception)
                      else (r.output, r.node_id, r.service) for r in out]
    rec["refusal"] = [str(r) for r in out if isinstance(r, Exception)]

    # queue autoscale
    for i in range(9):
        system.queue.put((core.Workload(f"q{i}", core.WorkloadKind.GENERIC),
                          ()))
    rec["autoscale_up"] = system.autoscale("svc-a", per_instance=2, max_n=5)
    while system.queue.depth() > 1:
        system.queue.get()
    rec["autoscale_down"] = system.autoscale("svc-a", per_instance=2)

    # node loss, then rejoin
    rec["moved"] = system.on_node_loss("n0")
    rec["after_loss"] = _placements(system)
    rec["healed"] = system.on_node_rejoin("n0")
    rec["after_rejoin"] = _placements(system)

    rec["events"] = list(system.events)
    rec["decisions"] = _decisions(system)
    rec["report"] = _report_view(system.report())
    path = tmp_path / f"{core.__name__}.json"
    state = system.save_state(str(path))
    rec["state"] = json.loads(json.dumps(state, sort_keys=True))
    rec["state_file"] = json.loads(path.read_text())
    return rec, path


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("core")
    return {"jax": _scenario(jcore, tmp), "torch": _scenario(tcore, tmp)}


@pytest.mark.parametrize("key", [
    "scale", "after_scale", "quota_refusal", "after_quota", "after_preempt",
    "pending", "evicted", "after_drain", "pending_after", "dispatch_order",
    "results", "refusal", "autoscale_up", "autoscale_down", "moved",
    "after_loss", "healed", "after_rejoin", "events", "decisions", "report",
    "state", "state_file"])
def test_control_plane_matches_jax(scenarios, key):
    jrec, trec = scenarios["jax"][0], scenarios["torch"][0]
    assert trec[key] == jrec[key]


def test_scenario_reaches_every_branch(scenarios):
    """The scenario really preempts, refuses, reorders and heals (so the
    parity above is not parity of no-ops)."""
    rec = scenarios["torch"][0]
    assert rec["evicted"] and rec["pending"] and not rec["pending_after"]
    assert "tenant-quota" in rec["quota_refusal"]
    assert rec["refusal"] and "flops_inflight" in rec["refusal"][0]
    assert rec["dispatch_order"][0][1] == "gold-0"      # QoS first
    order = [w for _, w in rec["dispatch_order"]]
    # t1 (weight 2) starts two items a round to t3's one; t3-1 is refused
    # on its FLOP quota, and be-0 finds no instance (the GUARANTEED
    # scale-up preempted it again)
    assert order[1:] == ["t3-0", "svc-a-0", "svc-a-1", "svc-a-2", "svc-a-3",
                         "t3-2"]
    assert rec["autoscale_up"] == 5 and rec["autoscale_down"] == 1
    assert rec["moved"] and rec["healed"] is not None
    assert any(e.startswith("preempt ") for e in rec["events"])
    assert any(e.startswith("failover ") for e in rec["events"])


def test_jax_state_file_restores_into_the_port(scenarios):
    jpath = scenarios["jax"][1]
    jstate = json.loads(jpath.read_text())
    log = []
    system = _system(tcore, log)
    applied = system.restore(str(jpath))
    assert sorted(applied) == sorted(s["name"] for s in jstate["specs"])
    # GUARANTEED first, then by priority (restore's admission order)
    ranks = [tcore.ServiceSpec.from_dict(s).admission_rank()
             for s in jstate["specs"]]
    assert [r for r in sorted(ranks)] == \
        [system.manager.specs[n].admission_rank() for n in applied]
    for d in jstate["specs"]:
        spec = system.manager.specs[d["name"]]
        assert spec.to_dict() == d
        assert len(system.instances(d["name"])) == d["replicas"]
    assert system.admission.quota_snapshot() == {
        t: tcore.TenantQuota(**q) for t, q in jstate["quotas"].items()}
    # and the port's own save of that state is the JAX file's content
    # (its specs in restore's order)
    out = json.loads(json.dumps(system.save_state(
        str(jpath.parent / "resaved.json")), sort_keys=True))
    by_name = sorted(jstate["specs"], key=lambda d: d["name"])
    assert sorted(out.pop("specs"), key=lambda d: d["name"]) == by_name
    assert out == {k: v for k, v in jstate.items() if k != "specs"}


def test_spec_and_workload_json_schema_match(exact_config):
    from repro_torch.models.config import ModelConfig
    jcfg = exact_config("edge-stream-light")
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    for core, cfg in ((jcore, jcfg), (tcore, tcfg)):
        w = core.Workload("w", core.WorkloadKind.DECODE, cfg, batch=2,
                          seq_len=8)
        assert core.classify(w) is core.WorkloadClass.LIGHT
    jspec = jcore.ServiceSpec(
        name="s", workload=jcore.Workload("w", jcore.WorkloadKind.DECODE,
                                          jcfg, batch=2, seq_len=8),
        qos=jcore.QoSClass.GUARANTEED, tenant="x", kv_dtype="int8")
    tspec = tcore.ServiceSpec.from_json(jspec.to_json())
    assert tspec.to_json() == jspec.to_json()
    assert tspec.workload.flops() == jspec.workload.flops()
    assert tspec.workload.bytes_touched() == jspec.workload.bytes_touched()
    assert tspec.resolve_executor_class().value == \
        jspec.resolve_executor_class().value
    assert tcfg.active_params() == jcfg.active_params()


@pytest.mark.parametrize("wrap", ["tuple", "dict", "list", "namedtuple"])
def test_clone_args_clones_tensors(wrap):
    """``clone_args`` gives a speculative backup tensors that share no
    storage with the primary's (a straight ``.copy()`` lookup would pass
    a tensor through, since it has none); numpy arrays still copy."""
    import collections
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    a = np.arange(4)
    NT = collections.namedtuple("NT", "t a")
    args = {"tuple": lambda: (t, (a, 3)), "dict": lambda: {"t": t, "a": a},
            "list": lambda: [t, [a]],
            "namedtuple": lambda: NT(t, a)}[wrap]()
    out = tcore.clone_args(args)
    assert type(out) is type(args)
    leaves = {"tuple": lambda o: (o[0], o[1][0]),
              "dict": lambda o: (o["t"], o["a"]),
              "list": lambda o: (o[0], o[1][0]),
              "namedtuple": lambda o: (o.t, o.a)}[wrap]
    ct, ca = leaves(out)
    assert isinstance(ct, torch.Tensor) and torch.equal(ct, t)
    assert ct.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    ct.add_(1)
    assert torch.equal(t, torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert isinstance(ca, np.ndarray) and not np.shares_memory(ca, a)


def test_telemetry_views_match_jax():
    """The finished telemetry port: windowed, per-tenant, per-replica and
    JSON views equal the JAX ones over the same samples."""
    stats = []
    for core in (jcore, tcore):
        s = core.DispatchStats()
        for i in range(7):
            s.record(core.DispatchSample(
                workload=f"w{i}", workload_class=("heavy", "light")[i % 2],
                executor_class=("container", "unikernel")[i % 2],
                executor="e", node="n", wall_s=0.01 * (i + 1),
                cold=i == 0, footprint_bytes=100 * i,
                service=f"s{i % 3}", tenant=f"t{i % 2}",
                replica=f"s{i % 3}/0"))
        s.set_extra("speculation", {"proposed": 3})
        stats.append(s)
    j, t = stats
    assert t.to_json(window=4) == j.to_json(window=4)
    assert t.to_json() == j.to_json()
    assert t.samples_for(service="s1") == \
        [tcore.DispatchSample(**dataclasses.asdict(x))
         for x in j.samples_for(service="s1")]
    fw = [0.1, 0.3, 0.2]
    assert tcore.DispatchStats.from_walls("x", fw).summary() == \
        jcore.DispatchStats.from_walls("x", fw).summary()


def test_failure_detector_drives_failover_and_rejoin():
    """A host missing heartbeats fails its node in both packages the same
    way; a beat heals it."""
    from repro.distributed.fault_tolerance import \
        FailureDetector as JDetector
    from repro_torch.distributed.fault_tolerance import \
        FailureDetector as TDetector

    events = []
    for core, Detector in ((jcore, JDetector), (tcore, TDetector)):
        now = [0.0]
        det = Detector(["n0", "n1", "n2"], timeout=5.0,
                       clock=lambda: now[0])
        log = []
        system = core.EdgeSystem(detector=det)
        for i in range(3):
            system.add_node(f"n{i}", core.NodeCapacity(hbm_bytes=100))
        Stub = _stub_class(core)
        system.register_builder(
            "generic", core.WorkloadClass.HEAVY,
            lambda w, m, S=Stub: (S("stub", w.name, log, m), 30))
        system.apply(_spec(core, "svc-a", replicas=3))
        now[0] = 6.0
        for h in ("n1", "n2"):
            det.heartbeat(h)
        assert det.poll() == ["n0"]
        det.heartbeat("n0")
        assert det.hosts["n0"].incarnation == 1
        events.append(list(system.events))
    assert events[0] == events[1]
    assert any(e.startswith("failover svc-a/") for e in events[1])
    assert "rejoin n0" in events[1]

"""The paper's two workloads on the port's edge system, against the JAX
package, on the CPU in fp32 (``exact_config``), with the JAX weights
bridged through ``repro_torch.models.weights``:

* stream analytics over 4 record batches: the port's unikernel image
  against JAX ``analytics_step`` and ``reference_analytics`` (2e-5);
* the unikernel decode image of reduced ``edge-stream-light``: 8 steps,
  the same tokens as the JAX unikernel image's, and a mismatching
  argument spec raises ``IncompatibleWorkload`` in both packages;
* the container builder's ``generic``, ``prefill`` and ``decode`` outputs
  against JAX's (2e-4 relative logits; argmax equal);
* ``EngineExecutor.dispatch`` on reduced ``tinyllama-1.1b``: the same
  tokens as the JAX ``EngineExecutor``'s, and footprints by the same
  formula;
* ``tests/test_system.py``'s three scenarios (mixed routing, failover
  mid-service, elastic scale), run on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.data import stream as jstream
from repro.models.model import build_model as jax_build
from repro.serving import router as jrouter
from repro_torch.configs import get_reduced_config
from repro_torch.data import stream as tstream
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.models.weights import from_numpy_tree
from repro_torch.serving import router as trouter
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
TOL = 2e-4


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) /
                 max(np.max(np.abs(want)), 1e-30))


def _bridge(exact_config, arch, seed=0):
    jcfg = exact_config(arch)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jp = jax_build(jcfg).init(jax.random.key(seed))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# stream analytics
# ---------------------------------------------------------------------------

def test_stream_image_matches_jax_and_reference():
    scfg = jstream.StreamConfig(num_users=8, batch_records=16)
    tcfg = tstream.StreamConfig(num_users=8, batch_records=16)
    jex, _ = jrouter.make_stream_builder(jcore.ImageRegistry(), scfg)(
        jcore.Workload("s", jcore.WorkloadKind.STREAM), None)
    treg = tcore.ImageRegistry()
    tex, fp = trouter.make_stream_builder(treg, tcfg, device="cpu")(
        tcore.Workload("s", tcore.WorkloadKind.STREAM), None)
    assert fp == tex.footprint_bytes() == tex.image.arg_bytes > 0
    assert tex.donates_inputs and treg.stats()["builds"] == 1
    jgen, tgen = jstream.make_record_stream(scfg), \
        tstream.make_record_stream(tcfg)
    jst, tst = jstream.init_state(scfg), tstream.init_state(tcfg, "cpu")
    seen = []
    for i in range(4):
        jrec, trec = next(jgen), next(tgen)
        for k in jrec:                         # the same generator, bit for bit
            assert np.array_equal(jrec[k], trec[k])
        seen.append(trec)
        jst, jout = jex.dispatch(
            jcore.Workload(f"s{i}", jcore.WorkloadKind.STREAM),
            (jst, {k: jnp.asarray(v) for k, v in jrec.items()}))
        tst, tout = tex.dispatch(
            tcore.Workload(f"s{i}", tcore.WorkloadKind.STREAM),
            (tst, tstream.to_device(trec, "cpu")))
        for k in ("avg_steps_per_user", "max_avg_steps"):
            assert _rel(jout[k], tout[k].numpy()) < 2e-5, k
        assert int(tout["argmax_user"]) == int(jout["argmax_user"])
        assert tout["argmax_user"].dtype == torch.int32
    allrec = {k: np.concatenate([r[k] for r in seen]) for k in seen[0]}
    avg, mx, arg = tstream.reference_analytics(allrec, tcfg.num_users)
    assert _rel(avg, tout["avg_steps_per_user"].numpy()) < 2e-5
    assert abs(float(tout["max_avg_steps"]) - mx) <= 2e-5 * mx
    assert int(tout["argmax_user"]) == arg
    for k in ("step_sum", "count"):
        assert _rel(jst[k], tst[k].numpy()) < 2e-5


def test_analytics_step_is_pure_and_ties_take_the_first_index():
    state = {"step_sum": torch.tensor([1.0, 3.0, 3.0]),
             "count": torch.ones(3)}
    before = {k: v.clone() for k, v in state.items()}
    batch = {"user_id": torch.tensor([0, 0], dtype=torch.int32),
             "total_steps": torch.tensor([1.0, 1.0])}
    new, out = tstream.analytics_step(state, batch)
    assert all(torch.equal(state[k], before[k]) for k in state)
    assert new["count"].tolist() == [3.0, 1.0, 1.0]
    assert int(out["argmax_user"]) == 1             # 3 ties 3: the first


# ---------------------------------------------------------------------------
# the unikernel decode image
# ---------------------------------------------------------------------------

class _F32CacheRegistry(jcore.ImageRegistry):
    """The JAX builder's image over fp32 caches: its decode step casts a
    bf16 cache to the compute dtype on write, so only fp32 caches keep
    one argument spec across steps at fp32 compute (the port's image keeps
    its caches in the compute dtype)."""

    def get_or_build(self, name, fn, args, donate_argnums=(), **kw):
        p, tok, caches, clen = args
        caches = jax.tree.map(lambda c: c.astype(jnp.float32), caches)
        return super().get_or_build(name, fn, (p, tok, caches, clen),
                                    donate_argnums, **kw)


def test_unikernel_decode_image_tokens_match_jax(exact_config):
    jcfg, tcfg, jp, tp = _bridge(exact_config, "edge-stream-light")
    max_seq = 32
    jw = jcore.Workload("d", jcore.WorkloadKind.DECODE, jcfg, batch=1)
    tw = tcore.Workload("d", tcore.WorkloadKind.DECODE, tcfg, batch=1)
    assert tcore.classify(tw) is tcore.WorkloadClass.LIGHT
    jex, _ = jrouter.make_unikernel_decode_builder(
        jcfg, _F32CacheRegistry(), params=jp, max_seq=max_seq)(jw, None)
    treg = tcore.ImageRegistry()
    tex, fp = trouter.make_unikernel_decode_builder(
        tcfg, treg, params=tp, max_seq=max_seq, device="cpu")(tw, None)
    assert tex.donates_inputs and tex.image.donated_argnums == (2,)
    assert fp == tex.image.arg_bytes and tex.image.output_bytes > 0

    jtok, tcaches = jnp.array([7], jnp.int32), None
    jcaches = jax_build(jcfg).init_caches(1, max_seq, jnp.float32)
    jlen = jnp.zeros((1,), jnp.int32)
    ttok = torch.tensor([7], dtype=torch.int32)
    tcaches = build_model(tcfg, "cpu").init_caches(1, max_seq,
                                                   torch.float32)
    tlen = torch.zeros((1,), dtype=torch.int32)
    jstream_, tstream_ = [], []
    for _ in range(8):
        jtok, jcaches, jlen = jex.dispatch(jw, (jp, jtok, jcaches, jlen))
        ttok, tcaches, tlen = tex.dispatch(tw, (tp, ttok, tcaches, tlen))
        jstream_.append(int(jtok[0]))
        tstream_.append(int(ttok[0]))
        assert ttok.dtype == torch.int32
    assert tstream_ == jstream_
    assert int(tlen[0]) == int(jlen[0]) == 8

    # a mismatching argument spec is rejected by both (C3)
    with pytest.raises(jcore.IncompatibleWorkload):
        jex.dispatch(jw, (jp, jnp.zeros((2,), jnp.int32), jcaches, jlen))
    with pytest.raises(tcore.IncompatibleWorkload):
        tex.dispatch(tw, (tp, torch.zeros((2,), dtype=torch.int32),
                          tcaches, tlen))
    with pytest.raises(tcore.IncompatibleWorkload):     # wrong dtype
        tex.dispatch(tw, (tp, ttok.long(), tcaches, tlen))
    assert not tex.can_run(tw, (tp, ttok, tcaches))
    # the registry keys images by spec and handle: a rebuild is a hit
    trouter.make_unikernel_decode_builder(
        tcfg, treg, params=tp, max_seq=max_seq, device="cpu")(tw, None)
    assert treg.stats() == {"builds": 1, "hits": 1, "images": 1}


class _ReplayGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    function over the static argument buffers and writes its results into
    the capture's output buffers, as a graph replays into its fixed
    addresses."""

    def __init__(self, fn, static, out):
        self.fn, self.static, self.out = fn, static, out

    def replay(self):
        for o, n in zip(leaves(self.out), leaves(self.fn(*self.static))):
            if o is not n:
                o.copy_(n)


def _as_captured(img, args):
    """Give a CPU image static buffers and a stand-in graph, as
    ``ExecutableImage._capture`` does on the card."""
    static = tree_map(lambda a: a.clone(), tuple(args))
    flat = leaves(static)
    v0 = [t._version for t in flat]
    with torch.no_grad():
        out = img.fn(*static)
    written = {i for i, (t, v) in enumerate(zip(flat, v0))
               if t._version != v}
    for t, a in zip(flat, leaves(args)):
        t.copy_(a)
    img._freeze(_ReplayGraph(img.fn, static, out), static, out, written)


def test_two_streams_through_one_image_keep_their_state():
    """Two decode streams interleaved through one image: its static
    buffers never leave it, each stream's caches come back in its own
    tensors, and each stream's tokens and caches equal its own eager run.
    A cache handed back right after its own step is not copied in; after
    the other stream's step it is."""
    cfg = get_reduced_config("edge-stream-light")
    model = build_model(cfg, "cpu")
    p = model.init(torch.Generator().manual_seed(0))
    w = tcore.Workload("d", tcore.WorkloadKind.DECODE, cfg, batch=1)
    ex, _ = trouter.make_unikernel_decode_builder(
        cfg, tcore.ImageRegistry(), params=p, max_seq=16,
        device="cpu")(w, None)
    img = ex.image

    def start(tok):
        return (torch.tensor([tok], dtype=torch.int32),
                model.init_caches(1, 16, cfg.cdtype),
                torch.zeros((1,), dtype=torch.int32))

    _as_captured(img, (p,) + start(0))
    assert img.captured
    streams, eager = {"a": start(3), "b": start(9)}, {"a": start(3),
                                                      "b": start(9)}
    copied = []
    for name in "aababb":
        tok, caches, clen = streams[name]
        before = img.copied_bytes
        streams[name] = ex.dispatch(w, (p, tok, caches, clen))
        copied.append(img.copied_bytes - before)
        got = leaves(streams[name][1])
        assert all(x is y for x, y in zip(got, leaves(caches)))
        assert not {id(x) for x in got} & {id(x) for x in
                                           leaves(img.static_args)}
        etok, ecaches, eclen = eager[name]
        with torch.no_grad():
            logits = model.decode(p, etok, ecaches, eclen)
        eager[name] = (torch.argmax(logits, -1).to(torch.int32), ecaches,
                       eclen + 1)
        for x, y in zip(leaves(streams[name]), leaves(eager[name])):
            assert torch.equal(x, y)
    assert not torch.equal(leaves(streams["a"][1])[0],     # two histories
                           leaves(streams["b"][1])[0])
    P = tcore.executor.tree_bytes(p)
    C = tcore.executor.tree_bytes(caches)
    # the params once, a stream's caches unless its own step came just
    # before, the int32 token and length every step
    assert copied == [P + C + 8, 8, C + 8, C + 8, C + 8, 8]
    assert img.replays == 6


def test_images_refuse_sharding():
    args = (torch.zeros(2),)
    with pytest.raises(NotImplementedError, match="item 13"):
        tcore.ExecutableImage.build("x", lambda a: a, args,
                                    in_shardings=object())
    with pytest.raises(NotImplementedError, match="item 13"):
        tcore.ExecutableImage.build("x", lambda a: a, args, mesh=object())
    with pytest.raises(TypeError):
        tcore.ExecutableImage.build("x", lambda a: a, (3,))


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

def test_container_entry_points_match_jax(exact_config):
    jcfg, tcfg, jp, tp = _bridge(exact_config, "tinyllama-1.1b")
    jex, jfp = jrouter.make_container_builder(jcfg, params=jp)(
        jcore.Workload("c", jcore.WorkloadKind.GENERIC), None)
    tex, tfp = trouter.make_container_builder(tcfg, params=tp,
                                              device="cpu")(
        tcore.Workload("c", tcore.WorkloadKind.GENERIC), None)
    assert tfp == jfp                    # params bytes, the same formula
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(1, 32)).astype(np.int32)

    def w(core, kind):
        return core.Workload(kind, core.WorkloadKind(kind), batch=1,
                             seq_len=32)

    jg = jex.dispatch(w(jcore, "generic"), (jnp.asarray(toks),))
    tg = tex.dispatch(w(tcore, "generic"), (torch.as_tensor(toks),))
    assert np.array_equal(np.asarray(jg), tg.numpy())
    assert tex.history[-1].compiled_fresh
    tex.dispatch(w(tcore, "generic"), (torch.as_tensor(toks),))
    assert not tex.history[-1].compiled_fresh        # same shapes: warm
    tex.dispatch(w(tcore, "generic"), (torch.as_tensor(toks[:, :16]),))
    assert tex.history[-1].compiled_fresh            # new shape

    S = 64
    jc = jax_build(jcfg).init_caches(1, S, jnp.float32)
    tc = build_model(tcfg, "cpu").init_caches(1, S, torch.float32)
    tc0 = {k: {kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
           else v.clone() for k, v in tc.items()}
    jl, jc, jlen = jex.dispatch(w(jcore, "prefill"), (jnp.asarray(toks), jc))
    tl, tc2, tlen = tex.dispatch(w(tcore, "prefill"),
                                 (torch.as_tensor(toks), tc))
    assert _rel(jl, tl.numpy()) < TOL
    assert int(jlen[0]) == int(tlen[0]) == 32
    # the caller's caches are left as they were (a copy was written)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(tc), jax.tree.leaves(tc0)))
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jex.dispatch(w(jcore, "decode"),
                              (jnp.asarray(tok), jc, jlen))
        tl, tc2 = tex.dispatch(w(tcore, "decode"),
                               (torch.as_tensor(tok), tc2, tlen))
        assert _rel(jl, tl.numpy()) < TOL
        assert np.array_equal(np.argmax(np.asarray(jl), -1),
                              tl.argmax(-1).numpy())
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jlen, tlen = jlen + 1, tlen + 1


# ---------------------------------------------------------------------------
# the engine executor
# ---------------------------------------------------------------------------

def test_engine_executor_matches_jax(exact_config):
    from repro.serving.engine import EngineExecutor as JEx
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.serving.engine import EngineExecutor as TEx
    from repro_torch.serving.engine import ServingEngine as TEngine

    jcfg, tcfg, jp, tp = _bridge(exact_config, "tinyllama-1.1b")
    jex = JEx("e", JEngine(jcfg, max_slots=2, max_seq=64, params=jp),
              autostart=False)
    tex = TEx("e", TEngine(tcfg, max_slots=2, max_seq=64, params=tp,
                           device="cpu"), autostart=False)
    assert tex.footprint_bytes() == jex.footprint_bytes()
    assert tex.footprint_bytes() == \
        tex._params_bytes + tex.engine.kv.capacity_bytes()
    assert tex.engine.spec_overhead_bytes() == 0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n) for n in (5, 19, 33)]
    for i, p in enumerate(prompts):
        jw = jcore.Workload(f"r{i}", jcore.WorkloadKind.DECODE, jcfg,
                            seq_len=6)
        tw = tcore.Workload(f"r{i}", tcore.WorkloadKind.DECODE, tcfg,
                            seq_len=6)
        assert tex.can_run(tw, (p,)) and not tex.can_run(tw, (p, p))
        jr = jex.dispatch(jw, (p,))
        tr = tex.dispatch(tw, (p,))
        assert list(tr.generated) == list(jr.generated)
        assert tex.dynamic_footprint_bytes() == \
            tex._params_bytes + tex.engine.kv.bytes_in_use()
        assert tex.dynamic_footprint_bytes() == jex.dynamic_footprint_bytes()
    assert tex.stats_extras() == {}


def test_engine_executor_charges_the_speculator(exact_config):
    jcfg, tcfg, jp, tp = _bridge(exact_config, "tinyllama-1.1b")
    from repro_torch.serving.engine import EngineExecutor, ServingEngine
    draft = ModelConfig.from_dict({**tcfg.to_dict(), "num_layers": 1})
    eng = ServingEngine(tcfg, max_slots=2, max_seq=64, params=tp,
                        device="cpu", draft_cfg=draft)
    ex = EngineExecutor("e", eng, autostart=False)
    d = eng._draft
    assert eng.spec_overhead_bytes() == d.footprint_bytes() == \
        d._params_bytes + d.kv.capacity_bytes() > 0
    assert ex.footprint_bytes() == ex._params_bytes + \
        eng.spec_overhead_bytes() + eng.kv.capacity_bytes()


# ---------------------------------------------------------------------------
# tests/test_system.py's scenarios, on the port
# ---------------------------------------------------------------------------

def _system(n_nodes=3):
    from repro_torch.configs import get_reduced_config
    system = tcore.EdgeSystem(policy=tcore.LeastLoadedPolicy())
    for i in range(n_nodes):
        system.add_node(f"edge{i}",
                        tcore.NodeCapacity(chips=1, hbm_bytes=10 ** 12))
    light_cfg = get_reduced_config("edge-stream-light")
    scfg = tstream.StreamConfig(num_users=8, batch_records=16)
    trouter.assemble_edge_system(system, heavy_cfg=light_cfg,
                                 light_cfg=light_cfg, scfg=scfg,
                                 device="cpu")
    return system, system.orchestrator, light_cfg, scfg


def test_mixed_workloads_route_and_complete():
    from repro_torch.launch import programs
    from repro_torch.optim import adamw

    mgr, orch, cfg, scfg = _system()
    gen = tstream.make_record_stream(scfg)
    state = tstream.init_state(scfg, "cpu")
    light_results, heavy_results = [], []
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    opt = adamw.init_state(params, programs.TrainConfig().adamw)
    for i in range(4):
        rec = tstream.to_device(next(gen), "cpu")
        res = mgr.submit(tcore.Workload(f"stream{i}",
                                        tcore.WorkloadKind.STREAM),
                         (state, rec))
        state, out = res.output
        light_results.append(res)
        w = tcore.Workload(f"train{i}", tcore.WorkloadKind.TRAIN, cfg,
                           batch=2, seq_len=16)
        toks = torch.zeros((2, 16), dtype=torch.int32)
        res2 = mgr.submit(w, (opt, {"tokens": toks, "labels": toks}))
        heavy_results.append(res2)
        _, _, metrics = res2.output
        assert torch.isfinite(metrics["loss"])
    assert all(r.workload_class == tcore.WorkloadClass.LIGHT
               for r in light_results)
    assert all(r.workload_class == tcore.WorkloadClass.HEAVY
               for r in heavy_results)
    # instances were REUSED after first deploy (continuous serving)
    assert sum(r.deployed_fresh for r in light_results) == 1
    assert sum(r.deployed_fresh for r in heavy_results) == 1
    # the container trains a copy: the caller's optimizer state is intact
    assert int(opt["step"]) == 0
    rep = mgr.report()
    assert rep["light"]["mean_footprint_bytes"] <= \
        rep["heavy"]["mean_footprint_bytes"]


def test_node_failure_mid_service_failover_and_continue():
    mgr, orch, cfg, scfg = _system(n_nodes=3)
    gen = tstream.make_record_stream(scfg)
    state = tstream.init_state(scfg, "cpu")
    rec = tstream.to_device(next(gen), "cpu")
    res = mgr.submit(tcore.Workload("s0", tcore.WorkloadKind.STREAM),
                     (state, rec))
    state, _ = res.output
    victim = res.node_id
    moved = orch.on_node_failure(victim)           # paper P4: redeploy
    assert moved, "instance should have been redeployed"
    assert orch.deployments[moved[0]].node_id != victim
    rec2 = tstream.to_device(next(gen), "cpu")
    res2 = mgr.submit(tcore.Workload("s1", tcore.WorkloadKind.STREAM),
                      (state, rec2))
    assert res2.node_id != victim
    state, out = res2.output
    assert np.isfinite(float(out["max_avg_steps"]))
    # the redeploy pulled the image from the registry, no second build
    assert mgr.registry.stats()["builds"] == 1
    assert mgr.registry.stats()["hits"] >= 1


def test_elastic_scale_with_load():
    system, orch, cfg, scfg = _system(n_nodes=4)
    for i in range(20):
        system.queue.put((tcore.Workload(f"pending{i}",
                                         tcore.WorkloadKind.GENERIC), ()))

    def builder(workload, mesh):
        ex = tcore.ContainerExecutor("svc", {"generic": lambda x: x},
                                     mesh=mesh)
        return ex, 10 ** 6

    system.register_builder("generic", tcore.WorkloadClass.HEAVY, builder)
    system.apply(tcore.ServiceSpec(
        name="svc", workload=tcore.Workload("svc",
                                            tcore.WorkloadKind.GENERIC),
        executor_class=tcore.ExecutorClass.CONTAINER, replicas=1,
        footprint_hint=10 ** 6))
    n = system.autoscale("svc", per_instance=4, max_n=8)
    assert n == 5                                   # ceil(20/4)
    while system.queue.depth() > 4:
        system.queue.get()
    n = system.autoscale("svc", per_instance=4, min_n=1)
    assert n == 1                                   # scaled down: saves power

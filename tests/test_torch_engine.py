"""The port's paged serving engine against the JAX ``ServingEngine``.

Same fp32 reduced tinyllama weights (through the weight bridge), same
prompts, same engine settings: the greedy token streams must be equal,
token for token, with prefix sharing on and off.  Plus the allocator
invariants, radix match and copy-on-write, warmup neutrality, failure
through futures, the background loop, and the golden fixture that
``chip_smoke.py`` replays on the card."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.configs import get_reduced_config as jax_reduced
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagedKVCache, autotune_page_size

torch.set_num_threads(1)


def _cfgs():
    jcfg = dataclasses.replace(jax_reduced("tinyllama-1.1b"),
                               compute_dtype="float32")
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _serve(engine, waves):
    """Submit each wave of prompts, drain, return streams in rid order."""
    for wave in waves:
        for p in wave:
            engine.submit(p, max_new_tokens=6)
        engine.run_until_drained()
    return [r.generated for r in sorted(engine.completed.values(),
                                        key=lambda r: r.rid)]


def _waves():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=40)
    return [[base, rng.integers(0, 256, size=37)],
            [np.concatenate([base[:29], rng.integers(0, 256, size=7)]),
             rng.integers(0, 256, size=5),
             np.concatenate([base[:35], rng.integers(0, 256, size=9)]),
             base[:20]]]


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_page_alloc_free_and_fragmentation():
    """Mirrors ``tests/test_paged_kv.py:96`` on the port's allocator."""
    _, cfg = _cfgs()
    kv = PagedKVCache(cfg, max_slots=3, max_seq=64, page_size=16,
                      num_pages=10, device="cpu")
    assert kv.pages_needed(1) == 1 and kv.pages_needed(17) == 2
    assert kv.pages_needed(10_000) == kv.pages_per_slot
    a = kv.alloc(40)
    b = kv.alloc(64)
    assert a is not None and b is not None
    assert kv.pages_in_use() == 7
    assert 0 not in kv.slot_pages[a[0]] + kv.slot_pages[b[0]]
    assert kv.alloc(40) is None
    assert kv.can_admit(30) and not kv.can_admit(40)
    c = kv.alloc(20)
    assert c is not None and kv.pages_in_use() == 9
    kv.free(b[0])
    assert kv.pages_in_use() == 5
    d = kv.alloc(60)
    assert d is not None and kv.pages_in_use() == 9
    assert len(kv.slot_pages[d[0]]) == 4
    kv.install(a[0], a[1], 33)
    assert int(kv.cache_len[a[0]]) == 33
    assert kv.page_table[a[0]].tolist()[:3] == kv.slot_pages[a[0]]
    kv.free(a[0])
    assert int(kv.page_table[a[0]].sum()) == 0
    assert int(kv.cache_len[a[0]]) == 0
    assert kv.bytes_in_use() == kv.pages_in_use() * kv._page_bytes
    assert kv.dense_equivalent_bytes() == \
        kv.max_slots * kv.pages_per_slot * kv._page_bytes
    with pytest.raises(ValueError, match="trash page"):
        PagedKVCache(cfg, max_slots=2, max_seq=64, page_size=16, num_pages=4,
                     device="cpu")


def test_refcounts_shared_pages_and_copy_page():
    _, cfg = _cfgs()
    kv = PagedKVCache(cfg, max_slots=3, max_seq=64, page_size=16,
                      num_pages=12, dtype=torch.float32, device="cpu")
    slot, row = kv.alloc(40)
    pages = list(kv.slot_pages[slot])
    kv.pools["attn"]["k"][:, pages[1]] = 7.0
    # attach the first page by reference and copy-seed from the second
    s2, row2 = kv.alloc(40, shared_pages=pages[:1], cow_src=pages[1])
    p2 = kv.slot_pages[s2]
    assert p2[0] == pages[0] and kv.page_refs[pages[0]] == 2
    assert kv.cow_copies == 1
    assert torch.all(kv.pools["attn"]["k"][:, p2[1]] == 7.0)
    kv.free(slot)
    assert pages[0] in kv.page_refs and pages[1] not in kv.page_refs
    assert kv.append_page(s2) is not None
    assert kv.pages_in_use() == len(kv.page_refs)
    kv.free(s2)
    assert kv.pages_in_use() == 0 and not kv.page_refs
    assert autotune_page_size(cfg) in (8, 16, 32, 64, 128)


# ---------------------------------------------------------------------------
# engine exactness against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_sharing", [True, False])
def test_token_streams_equal_jax_engine(prefix_sharing):
    jcfg, tcfg = _cfgs()
    kw = dict(max_slots=2, max_seq=64, page_size=16, num_pages=24,
              prefill_chunk=16, prefill_budget=16,
              prefix_sharing=prefix_sharing)
    je = JaxEngine(jcfg, seed=3, **kw)
    params = from_numpy_tree(jax.tree.map(np.asarray, je.params), tcfg,
                             "cpu")
    te = ServingEngine(tcfg, params=params, device="cpu", **kw)
    want = _serve(je, _waves())
    got = _serve(te, _waves())
    assert got == want
    js, ts = je.stats(), te.stats()
    for key in ("cow_copies", "kv_prefix_hits", "kv_prefix_misses",
                "preemptions", "decode_stalls", "pages_in_use"):
        assert ts[key] == js[key], key
    if prefix_sharing:
        assert ts["cow_copies"] >= 1 and ts["kv_prefix_hits"] >= 2


def test_page_pressure_preempts_and_stays_exact():
    """A pool too small for both requests' growth: decode growth evicts
    radix pages, preempts the best-effort request (requeue, never drop)
    and the streams still equal the JAX engine's."""
    jcfg, tcfg = _cfgs()
    kw = dict(max_slots=2, max_seq=64, page_size=8, num_pages=9,
              prefill_chunk=16, prefill_budget=16)
    je = JaxEngine(jcfg, seed=4, **kw)
    te = ServingEngine(tcfg, device="cpu", **kw, params=from_numpy_tree(
        jax.tree.map(np.asarray, je.params), tcfg, "cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=30), rng.integers(0, 256, size=20)]
    outs = []
    for eng in (je, te):
        eng.submit(prompts[0], max_new_tokens=20, qos="guaranteed")
        eng.submit(prompts[1], max_new_tokens=20, qos="best-effort")
        outs.append([r.generated for r in sorted(eng.run_until_drained(),
                                                 key=lambda r: r.rid)])
        assert eng.stats()["preemptions"] >= 1
    assert outs[0] == outs[1]


def test_full_length_prompt_stays_exact():
    """A prompt of exactly ``max_seq`` tokens fills every page; the first
    decode's append lands past the table and must go to the trash page
    (the clamp in ``_page_scatter``), not into a live page."""
    jcfg, tcfg = _cfgs()
    kw = dict(max_slots=2, max_seq=64)
    je = JaxEngine(jcfg, seed=6, **kw)
    te = ServingEngine(tcfg, device="cpu", **kw, params=from_numpy_tree(
        jax.tree.map(np.asarray, je.params), tcfg, "cpu"))
    p = np.random.default_rng(5).integers(0, 256, size=64)
    outs = []
    for eng in (je, te):
        eng.submit(p, max_new_tokens=8)
        (req,) = eng.run_until_drained()
        outs.append(req.generated)
    assert outs[0] == outs[1] and len(outs[1]) >= 1


def test_radix_match_and_cow_keep_shared_pages_intact():
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, max_slots=2, max_seq=64, prefill_chunk=16,
                        prefill_budget=16, device="cpu")
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, size=40)
    eng.submit(base, max_new_tokens=6)
    eng.run_until_drained()
    m = eng.prefix.match(np.concatenate([base[:35], [1, 2, 3]]),
                         touch=False)
    assert len(m.nodes) == 2 and m.matched_tokens == 35
    shared = [n.page for n in m.nodes]
    before = eng.kv.pools["attn"]["k"][:, shared].clone()
    eng.submit(np.concatenate([base[:35], rng.integers(0, 256, size=9)]),
               max_new_tokens=6)
    eng.step()                                   # admit + first chunk
    (req,) = eng.active.values()
    assert req.kv_shared_tokens == 35 and eng.kv.cow_copies == 1
    assert eng.kv.slot_pages[req.slot][:2] == shared
    eng.run_until_drained()
    assert torch.equal(eng.kv.pools["attn"]["k"][:, shared], before)
    assert eng.kv.pages_in_use() == eng.prefix.pages
    eng.release_prefix_cache()
    assert eng.kv.pages_in_use() == 0 and not eng.kv.page_refs


def test_warmup_is_state_neutral_and_idempotent():
    _, tcfg = _cfgs()
    kw = dict(max_slots=2, max_seq=64, prefill_chunk=16, prefill_budget=16,
              device="cpu", seed=5)
    cold = ServingEngine(tcfg, **kw)
    warm = ServingEngine(tcfg, **kw)
    pools = {k: v.clone() for k, v in warm.kv.pools["attn"].items()}
    warm.warmup().warmup()
    assert warm._warm and warm.ticks == 0
    for k, v in warm.kv.pools["attn"].items():        # only trash page 0
        assert torch.equal(v[:, 1:], pools[k][:, 1:])
    assert torch.equal(warm.kv.cache_len, cold.kv.cache_len)
    assert torch.equal(warm.last_tokens, cold.last_tokens)
    waves = _waves()
    assert _serve(warm, waves) == _serve(cold, waves)


def test_decode_error_fails_requests_through_futures():
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, max_slots=2, max_seq=64, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected decode fault")

    eng._decode = boom
    handles = [eng.submit(np.arange(5) + i, max_new_tokens=4)
               for i in range(2)]
    for h in handles:
        with pytest.raises(RuntimeError, match="injected decode fault"):
            h.result(timeout=30)
    assert len(eng.failed) == 2 and not eng.active
    assert eng.kv.pages_in_use() == 0 and len(eng.kv.free_slots) == 2


def test_background_loop_serves_and_validates():
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, max_slots=2, max_seq=64, device="cpu")
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(65, np.int32))
    with eng:
        hs = [eng.submit(np.arange(3 + i), max_new_tokens=3)
              for i in range(4)]
        done = [h.result(timeout=60) for h in hs]
    assert not eng.loop_running
    assert all(len(r.generated) == 3 for r in done)
    st = eng.stats()
    assert st["failed"] == 0 and "p50_ttft_s" in st


def test_unported_branches_raise():
    from repro_torch.core import EdgeSystem, NodeCapacity, WorkloadClass
    from repro_torch.serving.router import (fleet_service_spec,
                                            make_container_builder)

    jcfg, tcfg = _cfgs()
    # paged=False serves on dense slots (tests/test_torch_ssm.py), and so
    # does a window over full attention (tests/test_torch_layouts.py);
    # MLA without its config and the moe family without one raise with
    # JAX's own failure, and an encoder-only model over features is
    # refused at construction: it serves through a container's generic
    # entry point (tests/test_torch_encoder.py); over token ids it serves
    # on dense slots, as in JAX (tests/test_torch_layouts.py)
    with pytest.raises(NotImplementedError, match="mla=None"):
        ServingEngine(dataclasses.replace(tcfg, attn_type="mla"),
                      device="cpu", paged=False)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(dataclasses.replace(
            tcfg, encoder_only=True, frontend="audio_frames",
            frontend_dim=16), device="cpu")
    assert not ServingEngine(dataclasses.replace(tcfg, encoder_only=True),
                             device="cpu", max_seq=32).paged
    with pytest.raises(NotImplementedError, match="moe=None"):
        ServingEngine(dataclasses.replace(tcfg, family="moe"), device="cpu")
    ring = ServingEngine(dataclasses.replace(tcfg, sliding_window=8),
                         device="cpu", max_seq=32)
    assert not ring.paged and ring._stateful
    # the fleet is ported (ROADMAP item 10): as in the JAX package,
    # deploy_fleet refuses instances that are not engine-backed
    system = EdgeSystem()
    system.add_node("n0", NodeCapacity(hbm_bytes=1 << 30))
    system.register_builder("generic", WorkloadClass.HEAVY,
                            make_container_builder(tcfg, device="cpu"))
    with pytest.raises(ValueError, match="not engine-backed"):
        system.deploy_fleet(fleet_service_spec(tcfg, name="f", replicas=1))


# ---------------------------------------------------------------------------
# golden fixture
# ---------------------------------------------------------------------------

def test_golden_fixture_regenerates_and_port_reproduces_it():
    """The committed ``.npz`` equals a fresh JAX run (within 1e-6), and
    the port, fed the file alone, reproduces its streams on the CPU."""
    fresh = golden.make()
    with np.load(golden.PATH) as f:
        stored = {k: f[k] for k in f.files}
    assert sorted(stored) == sorted(fresh)
    for k, v in fresh.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(stored[k], v)
    cfg = ModelConfig.from_dict(json.loads(str(stored["config"])))
    params = from_numpy_tree(unflatten(
        {k[len("params/"):]: v for k, v in stored.items()
         if k.startswith("params/")}), cfg, "cpu")
    eng = ServingEngine(cfg, params=params, device="cpu",
                        **json.loads(str(stored["engine"])))
    for w in (0, 1):
        for p, n, pw in zip(stored["prompts"], stored["prompt_lens"],
                            stored["waves"]):
            if pw == w:
                eng.submit(p[:n], max_new_tokens=int(stored["max_new"]))
        eng.run_until_drained()
    got = [r.generated for r in sorted(eng.completed.values(),
                                       key=lambda r: r.rid)]
    assert got == stored["streams"].tolist()
    assert eng.kv.cow_copies == 1

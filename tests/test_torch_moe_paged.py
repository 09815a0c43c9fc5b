"""A full-attention MoE on the paged data plane, in the port, against the
JAX engine on the CPU: reduced ``mixtral-8x7b`` in fp32 without its
window, with and without one leading dense layer (``attn_dense`` pools
beside ``attn``).

- Greedy streams byte for byte and every counter (``cow_copies``,
  ``kv_prefix_hits``/``misses``, ``preemptions``, ``decode_stalls``,
  ``pages_in_use``, ``spec_rounds``, ``spec_accepted``,
  ``spec_proposed``) equal to the JAX engine's, through chunked prefill
  (prompts past the chunk of 16), prefix sharing in two waves (a radix
  hit and a copy-on-write of the boundary page, both stacks' pools),
  int8 pages, and speculation with a 1-layer tinyllama-shaped draft or
  the target as its own draft.
- Page pressure: a best-effort request preempted for a guaranteed one.
- Capacity drops: at capacity factor 0.25 the experts drop real tokens
  of the padded prefill chunks (a chunk's pad rows route and count toward
  ``_capacity(n_tok)``, as in JAX) and of the ``max_slots × K1`` rows of
  a verify pass (idle slots included); the port drops the same pairs,
  counted by a spy on ``_dispatch``.
- The pools: both stacks page, one table row addresses both, the bytes a
  token and the autotuned page size count both.
- The fixture ``tests/data/torch_moe_paged_golden.npz`` (stored config
  and parameter spec, no parameters) regenerates from JAX and replays on
  the CPU; ``chip_smoke.py`` replays it on the card."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_paged_golden as fixture
import torch_port_golden as golden
from repro.configs import get_reduced_config as jax_reduced
from repro.models.model import build_model as jax_build
from repro.serving import kv_cache as jkv
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

COUNTERS = ("cow_copies", "kv_prefix_hits", "kv_prefix_misses",
            "preemptions", "decode_stalls", "pages_in_use", "spec_rounds",
            "spec_accepted", "spec_proposed")


def _cfg(dense_first: bool, capacity: float = 1.25):
    mix = jax_reduced("mixtral-8x7b")
    moe = dataclasses.replace(mix.moe, capacity_factor=capacity,
                              first_dense_layers=int(dense_first),
                              first_dense_d_ff=256 if dense_first else 0)
    jcfg = dataclasses.replace(mix, attn_type="full", sliding_window=0,
                               compute_dtype="float32", moe=moe)
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _params(jcfg, tcfg, seed):
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(seed)), seed)
    return (jax.tree.map(jnp.asarray, flat),
            from_numpy_tree(flat, tcfg, "cpu"))


def _draft(kind, jcfg, tcfg, jp, tp):
    """(JAX engine knobs, port engine knobs) of a draft: none, a random
    1-layer tinyllama-shaped model, or the target itself."""
    if kind is None:
        return {}, {}
    if kind == "self":
        return (dict(draft_cfg=jcfg, draft_params=jp, spec_k_max=3),
                dict(draft_cfg=tcfg, draft_params=tp, spec_k_max=3))
    djcfg = dataclasses.replace(jax_reduced("tinyllama-1.1b"),
                                num_layers=1, compute_dtype="float32")
    dtcfg = ModelConfig.from_dict(djcfg.to_dict())
    djp, dtp = _params(djcfg, dtcfg, 9)
    return (dict(draft_cfg=djcfg, draft_params=djp, spec_k_max=3),
            dict(draft_cfg=dtcfg, draft_params=dtp, spec_k_max=3))


def _waves(eng, prompts, new=8):
    """The first prompt alone, then the rest (the second extends the
    first's first 35 tokens): streams in submission order."""
    for w in (prompts[:1], prompts[1:]):
        for p in w:
            eng.submit(p, max_new_tokens=new)
        eng.run_until_drained()
    assert not eng.failed
    return [list(r.generated) for r in sorted(eng.completed.values(),
                                              key=lambda r: r.rid)]


CASES = [(df, kv, d) for df in (False, True)
         for kv, d in (("auto", None), ("int8", None), ("int8", "tiny"),
                       ("auto", "self"))]


@pytest.mark.parametrize("dense_first, kv_dtype, draft", CASES,
                         ids=[f"{'dense-first' if df else 'moe-only'}-{kv}-"
                              f"{d or 'plain'}" for df, kv, d in CASES])
def test_paged_moe_streams_and_counters_equal_jax(dense_first, kv_dtype,
                                                  draft):
    jcfg, tcfg = _cfg(dense_first)
    jp, tp = _params(jcfg, tcfg, 5)
    jd, td = _draft(draft, jcfg, tcfg, jp, tp)
    kw = dict(max_slots=3, max_seq=128, page_size=16, prefill_chunk=16,
              kv_dtype=kv_dtype)
    je = JaxEngine(jcfg, params=jp, **kw, **jd).warmup()
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw, **td).warmup()
    assert je.paged and te.paged
    assert set(te.kv.pools) == ({"attn", "attn_dense"} if dense_first
                                else {"attn"})
    prompts = fixture.prompts()
    want, got = _waves(je, prompts), _waves(te, prompts)
    assert got == want and all(len(g) == 8 for g in got)
    js, ts = je.stats(), te.stats()
    for key in COUNTERS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert ts["cow_copies"] == 1 and ts["kv_prefix_hits"] == 1
    assert ts["prefill_chunks"] > len(prompts)          # chunked prefill
    if draft:
        assert ts["spec_rounds"] > 0
    if draft == "self":
        assert ts["spec_accepted"] > 0


@pytest.mark.parametrize("dense_first", [False, True])
def test_paged_moe_preemption_equals_jax(dense_first):
    """A pool of 9 pages of 8 for two requests that grow: decode growth
    preempts the best-effort one (requeued, never dropped); the streams
    and counters equal the JAX engine's."""
    jcfg, tcfg = _cfg(dense_first)
    jp, tp = _params(jcfg, tcfg, 6)
    kw = dict(max_slots=2, max_seq=64, page_size=8, num_pages=9,
              prefill_chunk=16, prefill_budget=16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=30), rng.integers(0, 256, size=20)]
    outs, stats = [], []
    for eng in (JaxEngine(jcfg, params=jp, **kw),
                ServingEngine(tcfg, params=tp, device="cpu", **kw)):
        eng.submit(prompts[0], max_new_tokens=20, qos="guaranteed")
        eng.submit(prompts[1], max_new_tokens=20, qos="best-effort")
        outs.append([r.generated for r in sorted(eng.run_until_drained(),
                                                 key=lambda r: r.rid)])
        stats.append(eng.stats())
    assert outs[0] == outs[1]
    assert stats[1]["preemptions"] >= 1
    for key in COUNTERS:
        assert stats[1][key] == stats[0][key], key


@pytest.mark.parametrize("dense_first", [False, True])
def test_capacity_drops_match_jax_in_chunks_and_verify(dense_first,
                                                       monkeypatch):
    """Capacity factor 0.25: an expert holds ``max(ceil(n·2/4·0.25), 8)``
    rows, so a 16-row prefill chunk (its pad rows included; 32 pairs for
    4 experts of 8 rows) and a verify pass over 6 slots × K1 rows (idle
    slots included; at K1 4, 48 pairs) drop pairs.  The streams equal the
    JAX engine's, speculative and not; the spy counts the dropped pairs
    by the kind of pass."""
    jcfg, tcfg = _cfg(dense_first, capacity=0.25)
    jp, tp = _params(jcfg, tcfg, 7)
    dropped = {"chunk": 0, "verify": 0, "decode": 0}
    real = tmoe._dispatch

    def spy(xt, gate, idx, capacity, cfg):
        buf, meta = real(xt, gate, idx, capacity, cfg)
        n = int((~meta[1]).sum())
        kind = "chunk" if xt.shape[0] == 16 else (
            "decode" if xt.shape[0] == 6 else "verify")
        dropped[kind] += n
        return buf, meta

    monkeypatch.setattr(tmoe, "_dispatch", spy)
    prompts = fixture.prompts()
    for draft in (None, "tiny"):
        jd, td = _draft(draft, jcfg, tcfg, jp, tp)
        kw = dict(max_slots=6, max_seq=128, page_size=16, prefill_chunk=16)
        je = JaxEngine(jcfg, params=jp, **kw, **jd)
        te = ServingEngine(tcfg, params=tp, device="cpu", **kw, **td)
        assert _waves(te, prompts) == _waves(je, prompts)
        assert te.stats()["spec_rounds"] == je.stats()["spec_rounds"]
    # a decode tick's 6 rows make 12 pairs: 4 experts of 8 rows drop
    # none of them here
    assert dropped["chunk"] > 0 and dropped["verify"] > 0, dropped
    assert dropped["decode"] == 0


@pytest.mark.parametrize("dense_first", [False, True])
def test_pools_and_accounting_cover_both_stacks(dense_first):
    jcfg, tcfg = _cfg(dense_first)
    for kv in ("auto", "int8"):
        jdt = jnp.float32 if kv == "auto" else jnp.int8
        tdt = torch.float32 if kv == "auto" else torch.int8
        assert tkv.kv_bytes_per_token(tcfg, tdt) == \
            jkv.kv_bytes_per_token(jcfg, jdt)
        assert tkv.autotune_page_size(tcfg, tdt) == \
            jkv.autotune_page_size(jcfg, jdt)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax_build(jcfg).init_paged_caches(5, 8, jdt))
        kvc = tkv.PagedKVCache(tcfg, 2, 32, page_size=8, num_pages=5,
                               dtype=tdt, device="cpu")
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).removeprefix("torch.")),
                           kvc.pools)
        assert got == want
    # a copy-on-write copies the page in every pool of both stacks
    slot, _ = kvc.alloc(10)
    src = kvc.slot_pages[slot][0]
    for stack in kvc.pools.values():
        for leaf in stack.values():
            leaf[:, src] = 3
    s2, _ = kvc.alloc(10, cow_src=src)
    dst = kvc.slot_pages[s2][0]
    for stack in kvc.pools.values():
        for leaf in stack.values():
            assert torch.all(leaf[:, dst] == 3)


# ---------------------------------------------------------------------------
# the card's fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored():
    with np.load(fixture.PATH) as f:
        return {k: f[k] for k in f.files}


def test_fixture_regenerates(stored):
    fresh = fixture.make()
    assert sorted(fresh) == sorted(stored)
    for k, v in fresh.items():
        np.testing.assert_array_equal(v, stored[k], err_msg=k)


@pytest.mark.parametrize("run", list(fixture.RUNS))
def test_fixture_replays_on_the_cpu(stored, run):
    """The port, fed the file alone (parameters drawn from the stored
    spec), gives every run's streams and counters."""
    g = stored
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    assert cfg.attn_type == "full" and cfg.sliding_window == 0
    assert cfg.moe.first_dense_layers == 1
    params = from_numpy_tree(unflatten(golden.draw(
        str(g["params_spec"]), int(g["params_seed"]))), cfg, "cpu")
    dcfg = ModelConfig.from_dict(json.loads(str(g["draft_config"])))
    dparams = from_numpy_tree(unflatten(golden.draw(
        str(g["draft_spec"]), int(g["draft_seed"]))), dcfg, "cpu")
    cfg, kw = fixture.run_setup(run, cfg, params, dcfg, dparams,
                                dataclasses.replace)
    eng = ServingEngine(cfg, params=params, device="cpu",
                        **json.loads(str(g["engine"])), **kw).warmup()
    prompts = [p[:n] for p, n in zip(g["prompts"], g["prompt_lens"])]
    got = fixture.serve(eng, prompts, int(g["max_new"]))
    np.testing.assert_array_equal(got, g[f"{run}_streams"])
    st = eng.stats()
    assert {k: st[k] for k in fixture.STATS} == json.loads(
        str(g[f"{run}_stats"]))

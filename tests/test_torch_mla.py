"""DeepSeek-V2's latent attention (MLA) and its leading dense layer in the
port against the JAX package, on the CPU: ``deepseek-v2-236b`` reduced (2
layers: one dense block, one MoE block of 4 experts, top 2, with the
shared expert) and in fp32.

- The plain attention versions at MLA's widths: ``ref.mha`` with q/k
  wider than v ((48, 32) and the published (192, 128)), causal with ragged
  valid lengths, and ``ref.decode_attention`` at (48, 32) over GQA and at
  the absorbed decode's (576, 512) with one KV head under 128 query
  heads, an empty row included; each against JAX ``kernels/ref.py`` and
  the Pallas kernel in interpret mode.
- MLA's ``attend`` with a cache (the prefill) and ``decode_step`` (the
  weight-absorbed decode), outputs and the latent ``c_kv``/``k_rope``
  caches, at the reduced and at the published MLA widths.
- ``Model.forward`` logits and aux, ``Model.loss``, the cache tree
  (``attn_dense`` beside ``attn``) and the parameter tree.
- Greedy ``ServingEngine`` streams byte-equal to the warmed JAX engine's
  (dense slots, pow2-bucketed whole-prompt prefill), with the engine
  stats that do not depend on the clock or the slot tree's dtype equal
  (warmup prefills every pow2 bucket once); and at 24 slots with capacity factor 0.25, where every decode tick
  drops (token, expert) pairs because idle slots' rows take expert
  capacity too.
- The golden fixture's ``deepseek_*`` entries (published MLA widths),
  which ``chip_smoke.py`` replays on the card; ``launch/serve.py --arch
  deepseek-v2-236b --reduced --device cpu``.
- ``check_ported``, ``num_params``/``active_params``/
  ``kv_bytes_per_token`` against JAX.

Tolerances: 2e-5 for the fp32 attention versions (``tests/test_kernels.py
:15``), 2e-4 relative for layer outputs, caches and logits
(``tests/test_decode_consistency.py:42``)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro.models.config import MLAConfig as JMLA
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

TOL = 2e-5
LOGIT_TOL = 2e-4
ARCH = "deepseek-v2-236b"


def _rel(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _cfgs(**over):
    """Reduced fp32 deepseek, the JAX and the port config."""
    jcfg = dataclasses.replace(jax_reduced(ARCH, **over),
                               compute_dtype="float32")
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _models(seed=0, **over):
    """Reduced fp32 deepseek's JAX parameters (norm scales seeded away
    from one) and the port's, through the bridge."""
    jcfg, tcfg = _cfgs(**over)
    flat = golden.seeded(jax.jit(jax_build(jcfg).init)(jax.random.key(seed)),
                         seed)
    return (jcfg, jax.tree.map(jnp.asarray, flat), tcfg,
            from_numpy_tree(flat, tcfg, "cpu"))


# ---------------------------------------------------------------------------
# the plain attention versions at MLA's widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dk, dv", [(48, 32), (192, 128)])
def test_plain_mha_with_values_narrower_than_keys(dk, dv):
    """B 2 x T 40, causal, valid lengths 40 and 23, G 1 (MLA's
    broadcast k_rope) and G 2, the scale (nope + rope)^-0.5."""
    rng = np.random.default_rng(dk)
    for Hq, Hkv in ((4, 4), (4, 2)):
        q, k = (rng.normal(size=(2, 40, h, dk)).astype(np.float32)
                for h in (Hq, Hkv))
        v = rng.normal(size=(2, 40, Hkv, dv)).astype(np.float32)
        valid = np.array([40, 23], np.int32)
        kw = dict(causal=True, sm_scale=dk ** -0.5)
        want = jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        kv_valid_len=jnp.asarray(valid), **kw)
        pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), kv_valid_len=jnp.asarray(valid),
                              interpret=True, block_q=16, block_k=16, **kw)
        got = tref.mha(torch.as_tensor(q), torch.as_tensor(k),
                       torch.as_tensor(v),
                       kv_valid_len=torch.as_tensor(valid), **kw)
        assert got.shape == (2, 40, Hq, dv)
        assert _rel(want, got) < TOL
        assert _rel(pallas, got) < TOL


@pytest.mark.parametrize("dk, dv, Hq, Hkv", [(48, 32, 8, 2),
                                             (576, 512, 128, 1)])
def test_plain_decode_with_values_narrower_than_keys(dk, dv, Hq, Hkv):
    """Over S 40 with lengths 40, 17 and 0: the empty row gives 0, as the
    Pallas kernel gives it (JAX's oracle averages the masked row, so it is
    held on the other rows only); values the first ``dv`` key columns, as
    the absorbed decode's ``c_kv`` is."""
    rng = np.random.default_rng(dk + Hq)
    q = rng.normal(size=(3, Hq, dk)).astype(np.float32)
    k = rng.normal(size=(3, 40, Hkv, dk)).astype(np.float32)
    v = np.ascontiguousarray(k[..., :dv])
    clen = np.array([40, 17, 0], np.int32)
    for softcap in (0.0, 30.0):
        kw = dict(softcap=softcap, sm_scale=192 ** -0.5)
        args = [jnp.asarray(a) for a in (q, k, v, clen)]
        want = np.asarray(jref.decode_attention(*args, **kw))
        pallas = np.asarray(pallas_decode(*args, interpret=True, block_k=16,
                                          **kw))
        got = tref.decode_attention(*(torch.as_tensor(a)
                                      for a in (q, k, v, clen)), **kw)
        assert got.shape == (3, Hq, dv)
        assert _rel(want[:2], got[:2]) < TOL
        assert _rel(pallas, got) < TOL
        assert bool((got[2] == 0).all()) and not pallas[2].any()


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

PUBLISHED = dict(mla=JMLA(q_lora_rank=64, kv_lora_rank=512,
                          qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128))


@pytest.mark.parametrize("over", [{}, PUBLISHED],
                         ids=["reduced-widths", "published-widths"])
def test_mla_prefill_and_absorbed_decode_match_jax(over):
    """A 20-token prompt through ``attend`` with a cache of 32 slots, then
    three decode steps at lengths 20, 21, 22 for row 0 and 20, 5, 6 for
    row 1 (a row whose later keys are stale): outputs and both latent
    caches."""
    jcfg, tcfg = _cfgs(**over)
    jp = jattn.init_attention(jax.random.key(3), jcfg)
    flat = golden.seeded(jp, 3)
    jp = jax.tree.map(jnp.asarray, flat)
    tp = from_numpy_tree(flat, tcfg, "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    # jitted: one compile each, in place of one per op and shape
    attend = jax.jit(jattn.attend, static_argnames=("cfg", "causal"))
    decode_step = jax.jit(jattn.decode_step, static_argnames=("cfg",))
    jc = jattn.init_cache(jcfg, 2, 32, jnp.float32)
    want, jc = attend(jp, jnp.asarray(x), jcfg, positions=pos, cache=jc)
    tc = tattn.init_cache(tcfg, 2, 32, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    with torch.no_grad():
        got = tattn.attend(tp, torch.as_tensor(x), tcfg,
                           positions=torch.as_tensor(pos), cache=tc)
    assert _rel(want, got) < LOGIT_TOL
    for key in ("c_kv", "k_rope"):
        assert _rel(jc[key], tc[key]) < LOGIT_TOL
    for lens in ([20, 20], [21, 5], [22, 6]):
        x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        clen = np.array(lens, np.int32)
        want, jc = decode_step(jp, jnp.asarray(x1), jcfg, jc,
                               jnp.asarray(clen))
        with torch.no_grad():
            got = tattn.decode_step(tp, torch.as_tensor(x1), tcfg, tc,
                                    torch.as_tensor(clen))
        assert got.shape == (2, 1, jcfg.d_model)
        assert _rel(want, got) < LOGIT_TOL
        for key in ("c_kv", "k_rope"):
            assert _rel(jc[key], tc[key]) < LOGIT_TOL


def test_deepseek_logits_aux_and_trees_match_jax():
    """40 tokens through the dense block then the MoE block: logits and
    aux; the tree the port makes itself, and its caches, have the JAX
    leaves and shapes (``dense_blocks``, ``attn_dense``)."""
    jcfg, jp, tcfg, tp = _models()
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               size=(2, 40))
    want, want_aux = jax.jit(jax_build(jcfg).forward)(
        jp, {"tokens": jnp.asarray(tokens)})
    model = Model(tcfg, "cpu")
    with torch.no_grad():
        got, aux = model.forward_with_aux(
            tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 40, jcfg.vocab_size)
    assert _rel(want, got) < LOGIT_TOL
    assert abs(float(aux) - float(want_aux)) < LOGIT_TOL * float(want_aux)
    assert float(aux) > 0
    own = model.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), own) == shapes
    assert set(shapes["stack"]) == {"blocks", "dense_blocks", "final_norm"}
    assert shapes["stack"]["dense_blocks"]["mlp"]["w_up"] == (1, 128, 256)
    want_c = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          jax_build(jcfg).init_caches(3, 48, jnp.float32))
    got_c = model.init_caches(3, 48, torch.float32)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                   .removeprefix("torch.")), got_c) == want_c
    assert set(got_c) == {"attn", "attn_dense"}


def test_deepseek_loss_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=3)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 32))
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 32))
    labels[:, :4] = -1
    want, wm = jax.jit(jax_build(jcfg).loss)(
        jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    got, gm = Model(tcfg, "cpu").loss(tp, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    for key in ("loss", "ce", "aux"):
        assert abs(float(gm[key]) - float(wm[key])) <= \
            LOGIT_TOL * abs(float(wm[key])), key
    assert float(gm["tokens"]) == float(wm["tokens"]) == 56
    assert abs(float(got) - float(want)) <= LOGIT_TOL * abs(float(want))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(m))
            for m in rng.integers(lo, hi, size=n)]


def _serve(eng, prompts, max_new):
    for p, n in zip(prompts, max_new):
        eng.submit(p, max_new_tokens=int(n))
    eng.run_until_drained()
    return [list(r.generated) for r in sorted(eng.completed.values(),
                                              key=lambda r: r.rid)]


# the stats that depend on neither the clock nor the slot tree's dtype
# (the JAX tree starts in bf16: ROADMAP Queue C)
_TIMED = ("_s", "_per_token", "_bytes")


def test_deepseek_engine_streams_equal_jax_engine():
    """Prompts of 40-90 tokens on 2 dense slots: each prefills once, whole,
    right-padded to a pow2 bucket of a ``max_seq`` 128; the JAX engine is
    warmed first, so its slot tree is in fp32 before the first insert."""
    jcfg, jp, tcfg, tp = _models(seed=2)
    kw = dict(max_slots=2, max_seq=128, prefill_chunk=16)
    je = JaxEngine(jcfg, params=jp, **kw).warmup()
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw).warmup()
    assert not te.paged and not te._stateful and not te._chunkable
    assert te.kv.caches["attn"]["c_kv"].shape == (1, 2, 128, 32)
    assert te.kv.caches["attn_dense"]["k_rope"].shape == (1, 2, 128, 16)
    prompts = _prompts(5, 40, 91, 0)
    want = _serve(je, prompts, [12] * 5)
    got = _serve(te, prompts, [12] * 5)
    assert got == want and all(len(g) == 12 for g in got)
    js, ts = je.stats(), te.stats()
    shared = {k for k in js if k in ts and not k.endswith(_TIMED)}
    assert {"failed", "ticks", "active", "queued", "paged"} <= shared
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
    assert ts["kv_capacity_bytes"] == 2 * js["kv_capacity_bytes"]
    assert ts["prefill_chunks"] == len(prompts)


def test_deepseek_warmup_prefills_every_bucket():
    """Whole-prompt prefill in pow2 buckets: warmup runs each bucket once
    (as the dense decoder on dense slots does; a sliding-window arch runs
    none), and the decode step on scratch caches."""
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, max_slots=2, max_seq=64, device="cpu")
    calls = []
    prefill = eng._prefill
    eng._prefill = lambda tokens, last: calls.append(tokens.shape[1]) or \
        prefill(tokens, last)
    eng.warmup()
    assert calls == eng.buckets == [16, 32, 64] and eng._warm
    assert int(eng.kv.cache_len.sum()) == 0


def test_moe_decode_drops_match_jax_engine():
    """24 slots at capacity factor 0.25: a decode tick routes all 24 rows,
    idle ones too, so its 48 (row, expert) pairs meet 4 experts of 8 rows
    and pairs drop at every tick; 20 prompts of 3-33 tokens with 3-23 new
    tokens each, through the dense block, the shared expert and the
    routed ones.  The JAX and the port engine drop the same pairs."""
    jcfg, tcfg = _cfgs()
    moe = dataclasses.replace(jcfg.moe, capacity_factor=0.25)
    jcfg = dataclasses.replace(jcfg, moe=moe)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    flat = golden.seeded(jax.jit(jax_build(jcfg).init)(jax.random.key(4)), 4)
    jp = jax.tree.map(jnp.asarray, flat)
    tp = from_numpy_tree(flat, tcfg, "cpu")
    kw = dict(max_slots=24, max_seq=64, prefill_chunk=16)
    rng = np.random.default_rng(4)
    prompts = _prompts(20, 3, 34, 4)
    new = rng.integers(3, 24, size=20)
    je = JaxEngine(jcfg, params=jp, **kw).warmup()
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw).warmup()
    want, got = _serve(je, prompts, new), _serve(te, prompts, new)
    assert [len(g) for g in got] == new.tolist()
    assert got == want


def test_golden_deepseek_replays_on_the_cpu():
    """The fixture's ``deepseek_*`` entries at the published MLA widths:
    the port, fed the file alone, gives the JAX engine's streams and
    ``Model.forward``'s last-position logits; ``chip_smoke.py`` replays
    them on the card through the flash kernel at (192, 128) and the
    dense decode kernel at (576, 512)."""
    pre = "deepseek_"
    with np.load(golden.PATH) as f:
        g = {k[len(pre):]: f[k] for k in f.files if k.startswith(pre)}
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    m = cfg.mla
    assert (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
            m.v_head_dim) == (512, 128, 64, 128)
    assert cfg.compute_dtype == "float32" and cfg.num_layers == 2
    assert cfg.moe.first_dense_layers == 1 and cfg.moe.num_shared_experts
    params = from_numpy_tree(unflatten(
        {k[len("params/"):]: v for k, v in g.items()
         if k.startswith("params/")}), cfg, "cpu")
    eng = ServingEngine(cfg, params=params, device="cpu",
                        **json.loads(str(g["engine"])))
    prompts = [p[:n] for p, n in zip(g["prompts"], g["prompt_lens"])]
    got = _serve(eng, prompts, [int(g["max_new"])] * len(prompts))
    assert got == g["streams"].tolist()
    with torch.no_grad():
        for p, want in zip(prompts, g["last_logits"]):
            lg = eng.model.forward(params, {"tokens": torch.from_numpy(
                p[None].astype(np.int64))})[0, -1]
            assert _rel(want, lg) < LOGIT_TOL


def test_serve_launcher_runs_reduced_deepseek(capsys):
    from repro_torch.launch import serve

    system = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "3", "--max-new", "6"])
    (dep,) = system.instances("llm-serving")
    eng = dep.executor.engine
    assert not eng.paged and len(eng.completed) == 3 and not eng.failed
    assert all(len(r.generated) == 6 for r in eng.completed.values())
    assert "dense slots" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# configs and refusals
# ---------------------------------------------------------------------------

def test_deepseek_config_and_counts_match_jax():
    full = get_config(ARCH)
    assert full.to_dict() == jax_config(ARCH).to_dict()
    assert get_reduced_config(ARCH).to_dict() == jax_reduced(ARCH).to_dict()
    for jcfg in (jax_config(ARCH), jax_reduced(ARCH),
                 dataclasses.replace(jax_config(ARCH), num_layers=4)):
        tcfg = ModelConfig.from_dict(jcfg.to_dict())
        check_ported(tcfg)
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.active_params() == jcfg.active_params()
        assert tcfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    assert full.num_params() == 235_741_434_880
    assert dataclasses.replace(full, num_layers=4).num_params() == \
        13_302_912_000
    assert full.kv_bytes_per_token() == (512 + 64) * 2


def test_mla_outside_the_moe_family_is_refused():
    """MLA outside the moe family, a full-attention moe and leading dense
    layers beside sliding-window attention build, as in JAX; MLA without
    its config is refused with JAX's failure; MLA has no paged pool and
    no chunked prefill, as in JAX."""
    ds = get_config(ARCH)
    tiny = get_config("tinyllama-1.1b")
    mix = get_config("mixtral-8x7b")
    # MLA in the dense decoder, the latent cache in a dense family, a
    # full-attention deepseek and mixtral with DeepSeek's leading dense
    # layer build as in JAX (tests/test_torch_layouts.py); MLA without
    # its config stays refused, naming JAX's own failure
    for cfg in (dataclasses.replace(tiny, attn_type="mla", mla=ds.mla),
                dataclasses.replace(ds, family="dense"),
                dataclasses.replace(ds, attn_type="full"),
                dataclasses.replace(mix, moe=ds.moe)):
        check_ported(cfg)
    with pytest.raises(NotImplementedError, match="mla=None"):
        check_ported(dataclasses.replace(ds, mla=None))
    with pytest.raises(NotImplementedError, match="AttributeError"):
        Model(dataclasses.replace(ds, mla=None), "cpu")
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="asserts attn_type"):
        tattn.init_paged_pool(tcfg, 4, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no chunked prefill"):
        tattn.prefill_chunk_dense({}, torch.zeros(1, 4, tcfg.d_model), tcfg,
                                  {}, torch.zeros(1, 4), torch.zeros(1))
    with pytest.raises(ValueError, match="speculative decoding needs"):
        ServingEngine(tcfg, device="cpu", draft_cfg=tcfg)

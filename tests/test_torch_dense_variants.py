"""The port's dense variants against the JAX package, on the CPU:
``gemma-2b`` (GeGLU, MQA, tied head, ``embed_scale``), ``command-r-35b``
(LayerNorm, parallel blocks), ``chameleon-34b`` (qk-norm, ``vq_tokens``)
and ``nemotron-4-340b`` (LayerNorm, relu2, untied head), reduced and in
fp32, gemma also at its head dim 256 and nemotron at 192; and reduced
tinyllama with attention biases.

- The JAX parameters cross through the weight bridge after their zero
  biases, LayerNorm biases and unit qk-norm and norm scales are replaced
  by seeded nonzero values (``torch_port_golden.seeded``), so a missing
  leaf would show.
- ``Model.forward`` logits within 2e-4 relative.
- Greedy ``ServingEngine`` streams (chunked prefill, paged decode, the
  radix pair's shared pages and copy-on-write) equal to the JAX engine's,
  token for token, with the same cache counters; gemma at head dim 256
  also speculatively over int8 pages and pages in fp32.
- The golden fixture's ``dense_*`` streams and logits, which
  ``chip_smoke.py`` replays on the card, reproduced from the file alone.
- The plain versions of the four attention kernels at head dims 192 and
  256 (``test_torch_gpu.py``'s ``WIDE_*`` cases, which the card holds
  the CUDA kernels against) against the JAX oracles
  (``repro.kernels.ref``).
- ``num_params`` of the four full configs against JAX.

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) for the kernels relative to the
largest output (``tests/test_kernels.py:15``); 2e-4 for logits
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
from repro.kernels import ref as jref
from repro.models.attention import _quantize as jax_quantize
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import _quantize as torch_quantize
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving.engine import ServingEngine
from test_torch_gpu import (WIDE_DECODE_CASES, WIDE_FLASH_CASES,
                            WIDE_PAGED_CASES, WIDE_VERIFY_CASES)

torch.set_num_threads(1)

ARCHS = ("gemma-2b", "command-r-35b", "chameleon-34b", "nemotron-4-340b")
# (arch, overrides of the reduced config): each arch as ``reduced`` makes
# it, gemma and nemotron at their real head dims, tinyllama with biases
VARIANTS = [(a, {}) for a in ARCHS] + [
    ("gemma-2b", dict(head_dim=256)), ("nemotron-4-340b", dict(head_dim=192)),
    ("tinyllama-1.1b", dict(attn_bias=True))]
IDS = [a + "".join(f"-{k}{v}" for k, v in o.items()) for a, o in VARIANTS]
ENGINE = dict(max_slots=2, max_seq=64, page_size=16, num_pages=24,
              prefill_chunk=16, prefill_budget=16)
LOGIT_TOL = 2e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-5 if name == "float32" else 3.5e-2


def _rel(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _pair(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _models(exact_config, arch, over, seed=0):
    """The JAX config and parameters (seeded nonzero where init makes
    zeros and ones) and the port's, through the bridge."""
    jcfg = exact_config(arch, **over)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(seed)), seed)
    return (jcfg, jax.tree.map(jnp.asarray, flat), tcfg,
            from_numpy_tree(flat, tcfg, "cpu"))


def _serve(eng, waves, max_new=6):
    for wave in waves:
        for p in wave:
            eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
    return [list(r.generated) for r in sorted(eng.completed.values(),
                                              key=lambda r: r.rid)]


def _waves():
    """Two waves: the second's first prompt shares 35 tokens with the
    first's (two whole pages attached and a third copy-seeded)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=40)
    return [[base, rng.integers(0, 256, size=23)],
            [np.concatenate([base[:35], rng.integers(0, 256, size=7)]),
             rng.integers(0, 256, size=5)]]


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, over", VARIANTS, ids=IDS)
def test_logits_match_jax(exact_config, arch, over):
    jcfg, jp, tcfg, tp = _models(exact_config, arch, over)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               size=(2, 23))
    want, _ = jax_build(jcfg).forward(jp, {"tokens": jnp.asarray(tokens)})
    model = Model(tcfg, "cpu")
    with torch.no_grad():
        got = model.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 23, jcfg.vocab_size)
    assert _rel(want, got) < LOGIT_TOL
    # the tree the port makes itself has the JAX leaves, shapes and all
    own = model.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), own) == shapes


@pytest.mark.parametrize("arch, over", VARIANTS, ids=IDS)
def test_engine_streams_equal_jax_engine(exact_config, arch, over):
    """Chunked prefill into pages, paged decode, the radix pair: the same
    tokens and the same cache counters as the JAX engine."""
    jcfg, jp, tcfg, tp = _models(exact_config, arch, over, seed=2)
    je = JaxEngine(jcfg, params=jp, **ENGINE)
    te = ServingEngine(tcfg, params=tp, device="cpu", **ENGINE)
    want, got = _serve(je, _waves()), _serve(te, _waves())
    assert got == want and all(len(g) == 6 for g in got)
    js, ts = je.stats(), te.stats()
    for key in ("cow_copies", "kv_prefix_hits", "kv_prefix_misses",
                "preemptions", "decode_stalls", "pages_in_use"):
        assert ts[key] == js[key], key
    assert ts["cow_copies"] == 1 and ts["kv_prefix_hits"] >= 1


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_gemma_speculative_streams_equal_jax_engine(exact_config, kv_dtype):
    """Reduced gemma at head dim 256 with a random one-layer draft: verify
    over K1 up to 4 and the draft's dense decode at D 256, pages in fp32
    or int8; the streams and the speculation counters equal the JAX
    speculative engine's, and the streams equal the port's own plain
    ones."""
    jcfg, jp, tcfg, tp = _models(exact_config, "gemma-2b",
                                 dict(head_dim=256), seed=3)
    djcfg = dataclasses.replace(jcfg, num_layers=1)
    dtcfg = ModelConfig.from_dict(djcfg.to_dict())
    dflat = golden.seeded(jax_build(djcfg).init(jax.random.key(4)), 4)
    kw = dict(max_slots=2, max_seq=64, spec_k_max=3, kv_dtype=kv_dtype)
    je = JaxEngine(jcfg, params=jp, draft_cfg=djcfg,
                   draft_params=jax.tree.map(jnp.asarray, dflat), **kw)
    te = ServingEngine(tcfg, params=tp, draft_cfg=dtcfg, device="cpu",
                       draft_params=from_numpy_tree(dflat, dtcfg, "cpu"),
                       **kw)
    waves = [[w[0] for w in _waves()] + [_waves()[0][1]]]
    want, got = _serve(je, waves, 10), _serve(te, waves, 10)
    assert got == want
    js, ts = je.stats(), te.stats()
    for key in ("spec_proposed", "spec_accepted", "spec_rounds",
                "draft_ticks", "decode_tokens_committed"):
        assert ts[key] == js[key], key
    assert ts["spec_rounds"] > 0 and "spec_disabled_reason" not in ts
    plain = ServingEngine(tcfg, params=tp, device="cpu", max_slots=2,
                          max_seq=64, kv_dtype=kv_dtype)
    assert _serve(plain, waves, 10) == got


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_dense_variants_replay_on_the_cpu(arch):
    """The fixture's ``dense_<arch>_*`` entries: the port, fed the file
    alone, gives the JAX engine's streams and ``Model.forward``'s
    last-position logits; ``chip_smoke.py`` replays them on the card."""
    pre = f"dense_{arch}_"
    with np.load(golden.PATH) as f:
        g = {k[len(pre):]: f[k] for k in f.files if k.startswith(pre)}
        prompts, lens = f["prompts"], f["prompt_lens"]
        waves, max_new = f["waves"], int(f["max_new"])
        engine = json.loads(str(f["engine"]))
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    want_hd = golden.DENSE_VARIANTS[arch].get("head_dim", 32)
    assert cfg.head_dim_ == want_hd and cfg.compute_dtype == "float32"
    params = from_numpy_tree(unflatten(
        {k[len("params/"):]: v for k, v in g.items()
         if k.startswith("params/")}), cfg, "cpu")
    eng = ServingEngine(cfg, params=params, device="cpu", **engine)
    got = _serve(eng, [[p[:n] for p, n, w in zip(prompts, lens, waves)
                        if w == wave] for wave in (0, 1)], max_new)
    assert got == g["streams"].tolist() and eng.kv.cow_copies == 1
    with torch.no_grad():
        for p, n, want in zip(prompts, lens, g["first_logits"]):
            lg = eng.model.forward(params, {"tokens": torch.from_numpy(
                p[None, :n].astype(np.int64))})[0, -1]
            assert _rel(want, lg) < LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_takes_the_dense_variants(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced``: the
    engine behind an ``EdgeSystem`` container on the paged plane."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--requests", "3",
                "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "paged KV" in out and "served 3 requests, 9 tokens" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_and_tied_head_match_jax(dtype):
    """gemma's ``embed_scale`` (sqrt(d) rounded to the compute dtype
    first, then one product in it: bit for bit in bf16) and its tied head
    at the full vocabulary of 256 000 (``x @ embeddingᵀ``), at a narrow
    width."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    jcfg = dataclasses.replace(jax_config("gemma-2b"), d_model=64,
                               compute_dtype=dtype)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(9)
    emb = (0.02 * rng.standard_normal((jcfg.vocab_size, 64))) \
        .astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 5))
    jx = jlayers.apply_embedding({"embedding": jnp.asarray(emb)},
                                 jnp.asarray(tokens), jcfg)
    tx = tlayers.apply_embedding({"embedding": torch.from_numpy(emb)},
                                 torch.from_numpy(tokens), tcfg)
    assert tx.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.float().numpy())
    want = jlayers.apply_lm_head({"embedding": jnp.asarray(emb)}, None, jx,
                                 jcfg)
    got = tlayers.apply_lm_head({"embedding": torch.from_numpy(emb)}, None,
                                tx, tcfg)
    assert got.shape == (2, 5, 256000)
    assert _rel(want, got) < _tol(dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_and_config_match_jax(arch):
    """The full configs field for field, and their exact parameter counts
    (the weights arithmetic of ``PERF.md`` reads these)."""
    j, t = jax_config(arch), get_config(arch)
    assert t.to_dict() == j.to_dict()
    assert t.num_params() == j.num_params()


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dims 192 and 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", WIDE_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_mha_matches_jax_ref(case, dtype):
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid = case
    rng = np.random.default_rng(Tq * D + Hq)
    q = rng.standard_normal((B, Tq, Hq, D), np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D), np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D), np.float32)
    vl = rng.integers(1, Tk + 1, size=(B,)).astype(np.int32) if valid \
        else None
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = tref.mha(tq, tk, tv, kv_valid_len=None if vl is None
                   else torch.from_numpy(vl), **kw)
    want = jref.mha(jq, jk, jv, kv_valid_len=None if vl is None
                    else jnp.asarray(vl), **kw)
    assert got.dtype == tq.dtype and _rel(want, got) < _tol(dtype)


def _pools(case_seed, P, page, Hkv, D, int8):
    rng = np.random.default_rng(case_seed)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    if not int8:
        return rng, kp, vp, None, None
    jk, jks = jax_quantize(jnp.asarray(kp))
    jv, jvs = jax_quantize(jnp.asarray(vp))
    tk, tks = torch_quantize(torch.from_numpy(kp))
    tv, tvs = torch_quantize(torch.from_numpy(vp))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    return rng, (jk, tk), (jv, tv), (jks, tks), (jvs, tvs)


def _paged_pair(case_seed, q_shape, P, page, Hkv, D, B, MP, K1, int8,
                dtype):
    """q, pools, table and lengths in both frameworks, and each one's
    keyword arguments (int8 pools: fp32 q, each package's own scales)."""
    rng, kp, vp, ks, vs = _pools(case_seed, P, page, Hkv, D, int8)
    q = rng.standard_normal(q_shape, np.float32)
    table = rng.integers(0, P, size=(B, MP)).astype(np.int32)
    clen = rng.integers(max(K1, 1), MP * page + 1, size=(B,)) \
        .astype(np.int32)
    if int8:
        jargs = (jnp.asarray(q), kp[0], vp[0])
        targs = (torch.from_numpy(q), kp[1], vp[1])
        jkw, tkw = dict(k_scale=ks[0], v_scale=vs[0]), \
            dict(k_scale=ks[1], v_scale=vs[1])
    else:
        (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
        jargs, targs, jkw, tkw = (jq, jk, jv), (tq, tk, tv), {}, {}
    jargs += (jnp.asarray(table), jnp.asarray(clen))
    targs += (torch.from_numpy(table), torch.from_numpy(clen))
    return jargs, targs, jkw, tkw


@pytest.mark.parametrize("case", WIDE_PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wide_paged_decode_matches_jax_ref(case, dtype):
    B, Hq, Hkv, D, page, MP, P, window, softcap = case
    int8 = dtype == "int8"
    jargs, targs, jkw, tkw = _paged_pair(MP * D + Hq, (B, Hq, D), P, page,
                                         Hkv, D, B, MP, 0, int8,
                                         "float32" if int8 else dtype)
    kw = dict(window=window, softcap=softcap)
    got = tref.paged_decode_attention(*targs, **kw, **tkw)
    want = jref.paged_decode_attention(*jargs, **kw, **jkw)
    assert got.shape == (B, Hq, D)
    assert _rel(want, got) < _tol("float32" if int8 else dtype)


@pytest.mark.parametrize("case", WIDE_VERIFY_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wide_paged_verify_matches_jax_ref(case, dtype):
    B, K1, Hq, Hkv, D, page, MP, P, softcap, window = case
    int8 = dtype == "int8"
    jargs, targs, jkw, tkw = _paged_pair(K1 * D + MP, (B, K1, Hq, D), P,
                                         page, Hkv, D, B, MP, K1, int8,
                                         "float32" if int8 else dtype)
    kw = dict(window=window, softcap=softcap)
    got = tref.paged_verify_attention(*targs, **kw, **tkw)
    want = jref.paged_verify_attention(*jargs, **kw, **jkw)
    assert got.shape == (B, K1, Hq, D)
    assert _rel(want, got) < _tol("float32" if int8 else dtype)


@pytest.mark.parametrize("case", WIDE_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_decode_attention_matches_jax_ref(case, dtype):
    B, Hq, Hkv, D, S, window, softcap = case
    rng = np.random.default_rng(S * 7 + D)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    clen = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(window=window, softcap=softcap)
    got = tref.decode_attention(tq, tk, tv, torch.from_numpy(clen), **kw)
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(clen), **kw)
    assert got.dtype == tq.dtype and _rel(want, got) < _tol(dtype)

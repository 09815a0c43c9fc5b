"""The port's speculative-decoding slice against the JAX package.

Plain ``paged_verify_attention`` and ``decode_attention`` against the JAX
oracles (``repro.kernels.ref``) and the Pallas kernels in interpret mode
on the same numpy inputs; ``Model.verify_paged`` and the dense
``Model.prefill``/``decode`` logits on the same weights; and the
speculative ``ServingEngine`` (int8 pages or not, random or zero-residual
draft) against the JAX speculative engine, token for token.  The CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) for the kernels, relative to the
largest output (``tests/test_kernels.py:15``); 2e-4 for model logits under
the fp32 ``exact_config`` (``tests/test_decode_consistency.py:42``)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.paged_verify_attention import \
    paged_verify_attention as pallas_verify
from repro.models.attention import _quantize as jax_quantize
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.kv_cache import SlotKVCache as JaxSlotKVCache
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import _quantize as torch_quantize
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import SlotKVCache
from test_torch_gpu import DECODE_CASES, VERIFY_CASES

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-5 if name == "float32" else 3.5e-2


def _rel(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _pair(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# paged verify attention
# ---------------------------------------------------------------------------

def _verify_inputs(case, seed):
    B, K1, Hq, Hkv, D, page, MP, P, softcap, window = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K1, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    table = rng.integers(0, P, size=(B, MP)).astype(np.int32)
    clen = rng.integers(K1, MP * page + 1, size=(B,)).astype(np.int32)
    return q, kp, vp, table, clen


@pytest.mark.parametrize("case", VERIFY_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_matches_jax_ref_and_pallas(case, dtype):
    softcap, window = case[8], case[9]
    q, kp, vp, table, clen = _verify_inputs(case, seed=case[0] * 131 + case[1])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    kw = dict(softcap=softcap, window=window)
    got = tref.paged_verify_attention(tq, tk, tv, torch.from_numpy(table),
                                      torch.from_numpy(clen), **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.paged_verify_attention(jq, jk, jv, jnp.asarray(table),
                                       jnp.asarray(clen), **kw)
    assert _rel(want, _np(got)) < _tol(dtype)
    pallas = pallas_verify(jq, jk, jv, jnp.asarray(table), jnp.asarray(clen),
                           interpret=True, **kw)
    assert _rel(pallas, _np(got)) < _tol(dtype)


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_paged_verify_int8_scales(case):
    """int8 pools quantized by each package's own ``_quantize``: the port's
    plain version dequantizes and matches the JAX oracle and the Pallas
    kernel, which folds the scales into the logits and probabilities."""
    softcap, window = case[8], case[9]
    q, kp, vp, table, clen = _verify_inputs(case, seed=case[1] * 17)
    jkq, jks = jax_quantize(jnp.asarray(kp))
    jvq, jvs = jax_quantize(jnp.asarray(vp))
    tkq, tks = torch_quantize(torch.from_numpy(kp))
    tvq, tvs = torch_quantize(torch.from_numpy(vp))
    np.testing.assert_array_equal(np.asarray(jvq), tvq.numpy())
    got = tref.paged_verify_attention(
        torch.from_numpy(q), tkq, tvq, torch.from_numpy(table),
        torch.from_numpy(clen), softcap=softcap, window=window,
        k_scale=tks, v_scale=tvs).numpy()
    kw = dict(softcap=softcap, window=window, k_scale=jks, v_scale=jvs)
    want = jref.paged_verify_attention(jnp.asarray(q), jkq, jvq,
                                       jnp.asarray(table), jnp.asarray(clen),
                                       **kw)
    assert _rel(want, got) < 2e-5
    pallas = pallas_verify(jnp.asarray(q), jkq, jvq, jnp.asarray(table),
                           jnp.asarray(clen), interpret=True, **kw)
    assert _rel(pallas, got) < 2e-5


def test_verify_k1_equals_paged_decode():
    """One verify token is one decode step, on plain pools and int8 ones."""
    case = (2, 1, 8, 2, 32, 16, 4, 11, 20.0, 0)
    q, kp, vp, table, clen = (torch.from_numpy(x) for x in
                              _verify_inputs(case, seed=5))
    (kq, ks), (vq, vs) = torch_quantize(kp), torch_quantize(vp)
    for k, v, sc in ((kp, vp, {}), (kq, vq, dict(k_scale=ks, v_scale=vs))):
        ver = tref.paged_verify_attention(q, k, v, table, clen, softcap=20.0,
                                          **sc)[:, 0]
        dec = tref.paged_decode_attention(q[:, 0], k, v, table, clen,
                                          softcap=20.0, **sc)
        torch.testing.assert_close(ver, dec, rtol=1e-5, atol=1e-5)


def test_verify_stale_suffix_never_reaches_the_output():
    """Huge values past ``cache_len`` (a rejected suffix of the last
    round) are masked in both probabilities and logits; the Pallas kernel
    agrees."""
    case = (2, 3, 4, 2, 32, 16, 4, 9, 0.0, 0)
    q, kp, vp, table, clen = _verify_inputs(case, seed=3)
    table[1] = [1, 2, 3, 4]
    clen[:] = [3, 20]
    kp[2, 4:] = 1e30                          # row 1: positions 20..31
    vp[2, 4:] = 1e30
    got = tref.paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(clen)).numpy()
    assert np.isfinite(got).all()
    pallas = pallas_verify(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(table), jnp.asarray(clen),
                           interpret=True)
    assert _rel(pallas, got) < 2e-5


# ---------------------------------------------------------------------------
# dense decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_ref_and_pallas(case, dtype):
    B, Hq, Hkv, D, S, window, softcap = case
    rng = np.random.default_rng(S * 7 + B)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    clen = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(window=window, softcap=softcap)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(clen), **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(clen), **kw)
    assert _rel(want, _np(got)) < _tol(dtype)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(clen), block_k=32,
                           interpret=True, **kw)
    assert _rel(pallas, _np(got)) < _tol(dtype)


def test_new_wrappers_take_the_plain_path_only_on_cpu():
    """``ops`` sends CPU tensors to the plain versions without counting a
    launch; the kernel wrappers refuse CPU tensors and a K1 past 8."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_verify_attention as pva

    before = (da.decode_attention.launches,
              pva.paged_verify_attention.launches)
    q = torch.zeros(1, 2, 2, 32)
    pools = torch.zeros(2, 16, 1, 32)
    table = torch.ones(1, 1, dtype=torch.int32)
    clen = torch.full((1,), 2, dtype=torch.int32)
    ops.paged_verify_attention(q, pools, pools, table, clen)
    ops.decode_attention(q[:, 0], pools[:1], pools[:1], clen)
    assert (da.decode_attention.launches,
            pva.paged_verify_attention.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        pva.paged_verify_attention(q, pools, pools, table, clen)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q[:, 0], pools[:1], pools[:1], clen)
    with pytest.raises(ValueError, match="K1=9"):
        pva.paged_verify_attention(torch.zeros(1, 9, 2, 32), pools, pools,
                                   table, clen)


# ---------------------------------------------------------------------------
# model: verify pass, dense prefill and decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(exact_config):
    jcfg = exact_config("tinyllama-1.1b")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(2))
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    tm = Model(tcfg, device="cpu")
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, jp, tm, tp


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_verify_paged_logits_match(pair, kv):
    """Prefill two rows into scrambled pages, then two verify blocks of 4
    tokens (the second after a rewind past a rejected suffix): logits
    match JAX ``verify_paged`` within 2e-4."""
    jcfg, jm, jp, tm, tp = pair
    page, MP, P = 8, 6, 16
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    table = np.array([[3, 9, 1, 14, 6, 11], [2, 12, 5, 8, 15, 4]], np.int32)
    jdt = jnp.int8 if kv == "int8" else jnp.float32
    tdt = torch.int8 if kv == "int8" else torch.float32
    jpool = jm.init_paged_caches(P, page, dtype=jdt)
    tpool = tm.init_paged_caches(P, page, dtype=tdt)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    lens = np.array([16, 11], np.int32)
    start = np.zeros(2, np.int32)
    errs = []
    with torch.no_grad():
        _, jpool = jm.prefill_chunk(jp, {"tokens": jnp.asarray(toks)}, jpool,
                                    jnp.asarray(start), jnp.asarray(lens),
                                    page_table=jt)
        tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks)}, tpool,
                         torch.from_numpy(start), torch.from_numpy(lens),
                         page_table=tt)
        clen = lens.copy()
        for _ in range(2):
            blk = rng.integers(0, jcfg.vocab_size, (2, 4)).astype(np.int32)
            jl, jpool = jm.verify_paged(jp, jnp.asarray(blk), jpool, jt,
                                        jnp.asarray(clen))
            tl = tm.verify_paged(tp, torch.from_numpy(blk), tpool, tt,
                                 torch.from_numpy(clen))
            assert tl.shape == (2, 4, jcfg.vocab_size)
            errs.append(_rel(jl, tl.numpy()))
            clen = clen + np.array([2, 1], np.int32)   # accept 1 and 0
    assert max(errs) < 2e-4, errs


def test_dense_prefill_and_decode_logits_match(pair):
    """A right-padded dense prefill (``last_index``) of two rows, then
    four dense decode steps: logits and lengths match JAX ``prefill`` and
    ``decode`` within 2e-4."""
    jcfg, jm, jp, tm, tp = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    last = np.array([15, 8], np.int32)
    jc = jm.init_caches(2, 32, jnp.float32)
    tc = tm.init_caches(2, 32, torch.float32)
    errs = []
    with torch.no_grad():
        jl, jc, jlen = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                                  last_index=jnp.asarray(last))
        tl, tlen = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                              last_index=torch.from_numpy(last))
        errs.append(_rel(jl, tl.numpy()))
        np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
        clen = np.asarray(jlen).astype(np.int32)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        for _ in range(4):
            jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jnp.asarray(clen))
            tl = tm.decode(tp, torch.from_numpy(nxt), tc,
                           torch.from_numpy(clen))
            errs.append(_rel(jl, tl.numpy()))
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            clen = clen + 1
    assert max(errs) < 2e-4, errs
    for name in ("k", "v"):      # the caches hold the same KV
        np.testing.assert_allclose(np.asarray(jc["attn"][name]),
                                   tc["attn"][name].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_slot_cache_matches_jax_accounting(exact_config):
    """The slot cache holds the JAX cache's leaves at its shapes and
    dtype; ``insert`` copies one batch-1 cache into one slot only."""
    jcfg = exact_config("tinyllama-1.1b")
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jkv = JaxSlotKVCache(jcfg, 3, 32, dtype=jnp.float32)
    tkv = SlotKVCache(tcfg, 3, 32, dtype=torch.float32, device="cpu")
    jleaves = jkv.caches["attn"]
    assert sorted(tkv.caches["attn"]) == sorted(jleaves)
    for name, leaf in tkv.caches["attn"].items():
        assert tuple(leaf.shape) == jleaves[name].shape
        assert leaf.dtype == torch.float32 and not bool(leaf.any())
    one = Model(tcfg, device="cpu").init_caches(1, 32, torch.float32)
    one["attn"]["k"].fill_(3.0)
    tkv.insert(one, 2, 17)
    assert int(tkv.cache_len[2]) == 17
    assert bool((tkv.caches["attn"]["k"][:, 2] == 3.0).all())
    assert not bool(tkv.caches["attn"]["k"][:, :2].any())


# ---------------------------------------------------------------------------
# the speculative engine against the JAX one
# ---------------------------------------------------------------------------

SPEC_KEYS = ("speculative", "spec_proposed", "spec_accepted",
             "acceptance_rate", "spec_rounds", "draft_ticks", "kv_dtype",
             "decode_tokens_committed", "pages_in_use", "preemptions")


def _zero_residual(params):
    names = {"w_o", "b_o", "w_down", "b_down"}

    def z(path, leaf):
        return (jnp.zeros_like(leaf)
                if getattr(path[-1], "key", None) in names else leaf)

    return jax.tree_util.tree_map_with_path(z, params)


def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return [list(r.generated) for r in sorted(eng.run_until_drained(),
                                              key=lambda r: r.rid)]


def _spec_pair(exact_config, kv_dtype, draft, **kw):
    """The JAX speculative engine and the port's on the same weights."""
    jcfg = exact_config("tinyllama-1.1b")
    dcfg = exact_config("tinyllama-1.1b", num_layers=1, num_heads=1,
                        num_kv_heads=1, d_ff=32)
    tp = jax_build(jcfg).init(jax.random.key(0))
    dp = jax_build(dcfg).init(jax.random.key(0))
    if draft == "zero_residual":
        tp, dp = _zero_residual(tp), _zero_residual(dp)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    tdcfg = ModelConfig.from_dict(dcfg.to_dict())
    je = JaxEngine(jcfg, params=tp, kv_dtype=kv_dtype, draft_cfg=dcfg,
                   draft_params=dp, **kw)
    te = ServingEngine(
        tcfg, params=from_numpy_tree(jax.tree.map(np.asarray, tp), tcfg,
                                     "cpu"),
        kv_dtype=kv_dtype, draft_cfg=tdcfg, device="cpu",
        draft_params=from_numpy_tree(jax.tree.map(np.asarray, dp), tdcfg,
                                     "cpu"), **kw)
    return je, te


@pytest.mark.parametrize("draft", ["random", "zero_residual"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_spec_streams_equal_jax_engine(exact_config, kv_dtype, draft):
    """Greedy streams, speculation counters and telemetry extras equal the
    JAX speculative engine's; the port's speculative streams equal its
    own non-speculative ones; the zero-residual pair (draft and target
    logits identical) accepts every draft token."""
    kw = dict(max_slots=3, max_seq=64, spec_k_max=3)
    je, te = _spec_pair(exact_config, kv_dtype, draft, **kw)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=n) for n in (9, 14, 5)]
    want = _drain(je, prompts, 12)
    got = _drain(te, prompts, 12)
    assert got == want
    js, ts = je.stats(), te.stats()
    for key in SPEC_KEYS:
        assert ts[key] == js[key], key
    assert ts["spec_rounds"] > 0 and "spec_disabled_reason" not in ts
    extra = te.dispatch_stats.extras()["speculation"]
    assert extra == je.dispatch_stats.extras()["speculation"]
    if draft == "zero_residual":
        assert ts["acceptance_rate"] == 1.0 and ts["spec_accepted"] > 0
    base = ServingEngine(te.cfg, params=te.params, kv_dtype=kv_dtype,
                         device="cpu", max_slots=3, max_seq=64)
    assert _drain(base, prompts, 12) == got


def test_spec_warmup_is_state_neutral():
    from repro_torch.configs import get_reduced_config

    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    dcfg = dataclasses.replace(cfg, num_layers=1)
    kw = dict(max_slots=2, max_seq=64, seed=3, device="cpu",
              draft_cfg=dcfg, spec_k_max=3, kv_dtype="int8")
    cold, warm = ServingEngine(cfg, **kw), ServingEngine(cfg, **kw)
    pools = {k: v.clone() for k, v in warm.kv.pools["attn"].items()}
    warm.warmup().warmup()
    assert warm._warm and warm.ticks == 0 and warm.spec_rounds == 0
    assert warm.draft_ticks == 0 and warm.kv.pages_in_use() == 0
    assert int(warm._draft.kv.cache_len.sum()) == 0
    for k, v in warm.kv.pools["attn"].items():        # only trash page 0
        assert torch.equal(v[:, 1:], pools[k][:, 1:])
    assert torch.equal(warm.kv.cache_len, cold.kv.cache_len)
    assert torch.equal(warm.last_tokens, cold.last_tokens)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n) for n in (21, 6)]
    assert _drain(warm, prompts, 9) == _drain(cold, prompts, 9)


def test_spec_engine_validates_and_survives_a_failing_draft():
    """Bad settings raise at construction; a draft that fails turns
    speculation off (``spec_disabled_reason``) and the requests complete
    with the non-speculative streams."""
    from repro_torch.configs import get_reduced_config

    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    dcfg = dataclasses.replace(cfg, num_layers=1)
    kw = dict(max_slots=2, max_seq=64, seed=1, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(cfg, kv_dtype="float16", **kw)
    with pytest.raises(ValueError, match="spec_k_max"):
        ServingEngine(cfg, draft_cfg=dcfg, spec_k_max=8, **kw)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(cfg, draft_cfg=dataclasses.replace(dcfg,
                                                         vocab_size=128),
                      **kw)
    eng = ServingEngine(cfg, draft_cfg=dcfg, **kw)

    def boom(*a, **k):
        raise RuntimeError("injected draft fault")

    eng._draft.propose = boom
    prompts = [np.arange(7), np.arange(3, 15)]
    got = _drain(eng, prompts, 6)
    st = eng.stats()
    assert not st["speculative"] and st["failed"] == 0
    assert "injected draft fault" in st["spec_disabled_reason"]
    assert got == _drain(ServingEngine(cfg, **kw), prompts, 6)


@pytest.mark.parametrize("where", ["propose", "prefill"])
def test_spec_engine_fails_the_batch_on_a_kernel_error(monkeypatch, where):
    """A draft kernel that fails to build or launch (``KernelError``) is
    not a draft fault to serve around: the requests fail through their
    results and speculation stays on, so the failure is seen."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.build import KernelError

    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    eng = ServingEngine(cfg, draft_cfg=dataclasses.replace(cfg, num_layers=1),
                        max_slots=2, max_seq=64, seed=1, device="cpu")

    def boom(*a, **k):
        raise KernelError("injected launch failure")

    if where == "propose":     # the draft's decode steps reach this kernel
        monkeypatch.setattr(ops, "decode_attention", boom)
    else:
        monkeypatch.setattr(eng._draft, "prefill", boom)
    for p in (np.arange(7), np.arange(3, 15)):
        eng.submit(p, max_new_tokens=6)
    assert eng.run_until_drained() == []
    st = eng.stats()
    assert st["failed"] == 2 and st["speculative"]
    assert "spec_disabled_reason" not in st
    assert all("injected launch failure" in r.error
               for r in eng.failed.values())


def test_spec_request_that_fills_max_seq_keeps_speculation_on(exact_config):
    """At acceptance 1.0 a request's last round ends at exactly
    ``max_seq``; its freed draft slot then rewrites its stale position
    ``max_seq`` every round (the dense cache's ``% S`` wrap) while the
    other request keeps speculating.  Streams equal the JAX speculative
    engine's, which commits one token more than the plain engine at the
    ``max_seq`` limit (ROADMAP Queue C)."""
    kw = dict(max_slots=2, max_seq=48, spec_k_max=3)
    je, te = _spec_pair(exact_config, "auto", "zero_residual", **kw)
    prompts = [np.arange(30), np.arange(100, 104)]
    want = _drain(je, prompts, 40)
    got = _drain(te, prompts, 40)
    assert got == want
    st = te.stats()
    assert "spec_disabled_reason" not in st and st["failed"] == 0
    assert st["acceptance_rate"] == 1.0
    assert int(te._draft.kv.cache_len.max()) == 48
    base = ServingEngine(te.cfg, params=te.params, device="cpu",
                         max_slots=2, max_seq=48)
    plain = _drain(base, prompts, 40)
    assert plain[1] == got[1] and plain[0] == got[0][:-1]
    assert len(prompts[0]) + len(plain[0]) == 48


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_golden_spec_streams_replay(kv_dtype):
    """The fixture's JAX speculative streams (random 1-layer draft), fed
    to the port from the file alone, as ``chip_smoke.py`` does on the
    card."""
    with np.load(golden.PATH) as f:
        g = {k: f[k] for k in f.files}
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    dcfg = ModelConfig.from_dict(json.loads(str(g["draft_config"])))

    def params(prefix, c):
        return from_numpy_tree(unflatten(
            {k[len(prefix):]: v for k, v in g.items()
             if k.startswith(prefix)}), c, "cpu")

    eng = ServingEngine(cfg, params=params("params/", cfg), device="cpu",
                        kv_dtype=kv_dtype, draft_cfg=dcfg,
                        draft_params=params("draft_params/", dcfg),
                        spec_k_max=int(g["spec_k_max"]),
                        **json.loads(str(g["engine"])))
    for w in (0, 1):
        for p, n, pw in zip(g["prompts"], g["prompt_lens"], g["waves"]):
            if pw == w:
                eng.submit(p[:n], max_new_tokens=int(g["max_new"]))
        eng.run_until_drained()
    got = [r.generated for r in sorted(eng.completed.values(),
                                       key=lambda r: r.rid)]
    assert got == g[f"spec_streams_{kv_dtype}"].tolist()
    assert eng.stats()["spec_rounds"] > 0 and eng.kv.cow_copies == 1

"""Every shape the JAX package's paths hand its Pallas kernels, held
against the JAX package on the CPU: head dim 16 (the JAX quickstart's and
elastic restart's four heads of 16, the JAX kernel tests' D 16 cases),
the verify pass at any K1 (the engine at any ``spec_k_max``), and MLA's
absorbed decode at the reduced config's keys of 48 over values of 32.

The plain versions (``repro_torch.kernels.ref``) against the JAX oracles
and Pallas kernels in interpret mode on the same numpy inputs, at the
cases ``tests/test_torch_gpu.py`` holds the CUDA kernels to on the card;
the port's speculative engine at ``spec_k_max`` 8 and 12 against the JAX
engine; the fixture's ``quickstart_*``, ``deepseek_reduced_*`` and
``spec_k12_*`` entries (``tests/torch_port_golden.py``) replayed by the
port from the file alone, as ``chip_smoke.py`` phase 5 replays them on
the card.

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) for the kernels, relative to
the largest output (``tests/test_kernels.py:15``); 2e-4 for model logits
(``tests/test_decode_consistency.py:42``); 1e-4 for a training replay
(``tests/test_torch_train.py``)."""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.kernels import ref as jref
from repro.kernels.blocked_attention import mha_blocked
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as pallas_bwd
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged
from repro.kernels.paged_verify_attention import \
    paged_verify_attention as pallas_verify
from repro.models.attention import _quantize as jax_quantize
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.kernels import ATTENTION_DIMS
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import _quantize as torch_quantize
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving.engine import ServingEngine
from test_torch_gpu import (D16_DECODE_CASES, D16_FLASH_CASES,
                            D16_PAGED_CASES, MLA_REDUCED_DECODE_CASES,
                            VERIFY_ANY_K1_CASES)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3.5e-2)}


def _rel(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _pair(x, dtype):
    """The same values in both frameworks (bf16 rounding is identical)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# ---------------------------------------------------------------------------
# the plain versions at the new shapes
# ---------------------------------------------------------------------------

def _flash_inputs(case, seed):
    """q, k, v, do and, with ``valid``, lengths whose first row is 0."""
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, np.float32) for s in
            ((B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D),
             (B, Tq, Hq, D))]
    vl = np.array([0] + [Tk // 2] * (B - 1), np.int32) if valid else None
    return arrs, dict(causal=causal, window=window, softcap=softcap), vl


@pytest.mark.parametrize("case", D16_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_forward_at_d16(case, dtype):
    """``ref.mha`` at head dim 16 against the JAX oracle and the Pallas
    forward in interpret mode, its ``lse`` against the Pallas one's."""
    (q, k, v, _), kw, vl = _flash_inputs(case, seed=case[1] * 5 + case[3])
    tol = DTYPES[dtype][2]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jvl = None if vl is None else jnp.asarray(vl)
    got, lse = tref.mha(tq, tk, tv, return_lse=True, kv_valid_len=None
                        if vl is None else torch.from_numpy(vl), **kw)
    assert got.dtype == tq.dtype and got.shape[-1] == 16
    assert _rel(jref.mha(jq, jk, jv, kv_valid_len=jvl, **kw), got) < tol
    want, want_lse = pallas_flash(jq, jk, jv, kv_valid_len=jvl,
                                  return_lse=True, interpret=True,
                                  block_q=16, block_k=16, **kw)
    assert _rel(want, got) < tol
    assert _rel(want_lse, lse) < 2e-5


@pytest.mark.parametrize("case", D16_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_backward_at_d16(case, dtype):
    """``ref.flash_attention_bwd`` (dq, and dk and dv summed over each KV
    head's queries) at head dim 16 against the Pallas dq and dk/dv
    kernels in interpret mode on the same q, k, v, out, lse and do, and
    against the blocked flash-semantics backward (``jax.vjp`` of
    ``mha_blocked``)."""
    jdt, tdt, tol = DTYPES[dtype]
    (q, k, v, do), kw, vl = _flash_inputs(case, seed=case[2] * 3 + case[4])
    pos = {} if vl is None else {"kv_valid_len": vl}
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jpos = {n: jnp.asarray(x) for n, x in pos.items()}
    out, lse = pallas_flash(jq, jk, jv, return_lse=True, interpret=True,
                            block_q=16, block_k=16, **kw, **jpos)
    want = pallas_bwd(jq, jk, jv, out, lse, jdo, interpret=True,
                      block_q=16, block_k=16, **kw, **jpos)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    got = tref.flash_attention_bwd(
        tq, tk, tv, torch.from_numpy(np.array(out, np.float32)).to(tdt),
        torch.from_numpy(np.array(lse)), tdo, **kw,
        **{n: torch.from_numpy(x) for n, x in pos.items()})
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        assert _rel(w, g) < tol, (name, _rel(w, g))
    if dtype == "float32":
        _, vjp = jax.vjp(lambda q, k, v: mha_blocked(
            q, k, v, block_k=16, **kw, **jpos), jq, jk, jv)
        for name, w, g in zip(("dq", "dk", "dv"), vjp(jdo), got):
            assert _rel(w, g) < 2e-5, (name, _rel(w, g))


def _paged_inputs(case, seed, K1=0):
    if K1:
        B, K1, Hq, Hkv, D, page, MP, P = case[:8]
    else:
        B, Hq, Hkv, D, page, MP, P = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K1, Hq, D) if K1 else (B, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    table = rng.integers(0, P, size=(B, MP)).astype(np.int32)
    clen = rng.integers(max(K1, 1), MP * page + 1, size=(B,)) \
        .astype(np.int32)
    return q, kp, vp, table, clen


def _pools(kp, vp, int8, dtype):
    """(JAX pools, port pools, JAX scales, port scales): in ``dtype``, or
    int8 by each package's own ``_quantize``."""
    if not int8:
        (jk, tk), (jv, tv) = _pair(kp, dtype), _pair(vp, dtype)
        return (jk, jv), (tk, tv), {}, {}
    (jkq, jks), (jvq, jvs) = (jax_quantize(jnp.asarray(x)) for x in (kp, vp))
    (tkq, tks), (tvq, tvs) = (torch_quantize(torch.from_numpy(x))
                              for x in (kp, vp))
    np.testing.assert_array_equal(np.asarray(jkq), tkq.numpy())
    return ((jkq, jvq), (tkq, tvq), dict(k_scale=jks, v_scale=jvs),
            dict(k_scale=tks, v_scale=tvs))


@pytest.mark.parametrize("case", D16_PAGED_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_paged_decode_at_d16(case, int8, dtype):
    """``ref.paged_decode_attention`` at head dim 16 over pools in the
    compute dtype or int8, against the JAX oracle and the Pallas kernel
    in interpret mode."""
    q, kp, vp, table, clen = _paged_inputs(case, seed=case[0] * 7 + case[5])
    jq, tq = _pair(q, dtype)
    (jk, jv), (tk, tv), jsc, tsc = _pools(kp, vp, int8, dtype)
    kw = dict(window=case[7], softcap=case[8])
    args_t = (torch.from_numpy(table), torch.from_numpy(clen))
    args_j = (jnp.asarray(table), jnp.asarray(clen))
    got = tref.paged_decode_attention(tq, tk, tv, *args_t, **kw, **tsc)
    tol = DTYPES[dtype][2]
    assert got.dtype == tq.dtype
    assert _rel(jref.paged_decode_attention(jq, jk, jv, *args_j, **kw,
                                            **jsc), got) < tol
    assert _rel(pallas_paged(jq, jk, jv, *args_j, interpret=True, **kw,
                             **jsc), got) < tol


@pytest.mark.parametrize("case", VERIFY_ANY_K1_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_verify_at_any_k1(case, int8, dtype):
    """``ref.paged_verify_attention`` at D 16 and at K1 9, 13 and 16 (G 8
    and 12 at D 64 and 256, G 1 at D 32), over pools in the compute
    dtype or int8, against the JAX oracle and the Pallas verify kernel
    in interpret mode."""
    q, kp, vp, table, clen = _paged_inputs(case, seed=case[1] * 11 + case[4],
                                           K1=case[1])
    jq, tq = _pair(q, dtype)
    (jk, jv), (tk, tv), jsc, tsc = _pools(kp, vp, int8, dtype)
    kw = dict(softcap=case[8], window=case[9])
    args_t = (torch.from_numpy(table), torch.from_numpy(clen))
    args_j = (jnp.asarray(table), jnp.asarray(clen))
    got = tref.paged_verify_attention(tq, tk, tv, *args_t, **kw, **tsc)
    tol = DTYPES[dtype][2]
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _rel(jref.paged_verify_attention(jq, jk, jv, *args_j, **kw,
                                            **jsc), got) < tol
    assert _rel(pallas_verify(jq, jk, jv, *args_j, interpret=True, **kw,
                              **jsc), got) < tol


@pytest.mark.parametrize("case", D16_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dense_decode_at_d16(case, dtype):
    B, Hq, Hkv, D, S, window, softcap = case
    rng = np.random.default_rng(S + Hq)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D), np.float32)
            for _ in range(2))
    clen = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(window=window, softcap=softcap)
    got = tref.decode_attention(tq, tk, tv, torch.from_numpy(clen), **kw)
    tol = DTYPES[dtype][2]
    assert _rel(jref.decode_attention(jq, jk, jv, jnp.asarray(clen), **kw),
                got) < tol
    assert _rel(pallas_decode(jq, jk, jv, jnp.asarray(clen), block_k=32,
                              interpret=True, **kw), got) < tol


@pytest.mark.parametrize("case", MLA_REDUCED_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_at_reduced_mla_widths(case, dtype):
    """Keys of 48 (latent 32 and rope 16) over values of 32 under one KV
    head, the values the keys' first 32 columns as the absorbed decode
    passes them: ``ref.decode_attention`` against the JAX oracle and
    the Pallas kernel in interpret mode, and with ``return_lse`` the same
    output and each row's log-sum-exp of its scaled, capped logits
    (NEG_INF for a row with no valid key)."""
    B, Hq, S, lengths, softcap = case
    rng = np.random.default_rng(S + Hq + 48)
    q = rng.standard_normal((B, Hq, 48), np.float32)
    k = rng.standard_normal((B, S, 1, 48), np.float32)
    v = np.ascontiguousarray(k[..., :32])
    clen = (rng.integers(36, 544, size=B) if lengths is None
            else np.array(lengths)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(softcap=softcap, sm_scale=48 ** -0.5)
    tc = torch.from_numpy(clen)
    got = tref.decode_attention(tq, tk, tv, tc, **kw)
    out, lse = tref.decode_attention(tq, tk, tv, tc, return_lse=True, **kw)
    tol = DTYPES[dtype][2]
    assert got.shape == (B, Hq, 32) and got.dtype == tq.dtype
    live = clen > 0            # the JAX oracle spreads an empty row evenly
    assert _rel(jref.decode_attention(jq, jk, jv, jnp.asarray(clen), **kw)
                [live], got[torch.from_numpy(live)]) < tol
    assert _rel(pallas_decode(jq, jk, jv, jnp.asarray(clen), block_k=32,
                              interpret=True, **kw), got) < tol
    assert torch.equal(out, got) and lse.dtype == torch.float32
    s = np.einsum("bhd,bsd->bhs", tq.double().numpy() * 48 ** -0.5,
                  tk.double().numpy()[:, :, 0])
    if softcap:
        s = np.tanh(s / softcap) * softcap
    for b in range(B):
        n = min(int(clen[b]), S)
        if n == 0:
            assert (lse[b].numpy() == np.float32(tref.NEG_INF)).all()
            assert not got[b].float().numpy().any()
            continue
        m = s[b, :, :n].max(-1)
        want = m + np.log(np.exp(s[b, :, :n] - m[:, None]).sum(-1))
        np.testing.assert_allclose(lse[b].numpy(), want, rtol=1e-5,
                                   atol=1e-4)


def test_one_head_dim_table_for_the_attention_wrappers():
    """The four attention wrappers read their kind's entry of
    ``ATTENTION_DIMS``: head dim 16 in every kind, (48, 32) in flash and
    in dense decode, MLA's published (576, 512) in dense decode only; the
    verify wrapper's row groups follow the kernel's layouts (64 rows, 32
    at D 192 and 256), and a K1 of 0 is refused."""
    from repro_torch.kernels import paged_verify_attention as pva

    for kind in ("flash", "paged", "decode"):
        assert (16, 16) in ATTENTION_DIMS[kind]
    assert (48, 32) in ATTENTION_DIMS["flash"]
    assert (48, 32) in ATTENTION_DIMS["decode"]
    assert (576, 512) in ATTENTION_DIMS["decode"]
    assert (48, 32) not in ATTENTION_DIMS["paged"]
    assert set(ATTENTION_DIMS["paged"]) < set(ATTENTION_DIMS["flash"])
    assert [pva.row_groups(k1, 8, 64) for k1 in (1, 8, 9, 13, 16)] == \
        [1, 1, 2, 2, 2]
    assert [pva.row_groups(k1, 8, 256) for k1 in (4, 5, 9, 16)] == \
        [1, 2, 3, 4]
    assert pva.row_groups(16, 12, 64) == 3
    with pytest.raises(ValueError, match="K1=0"):
        pva.paged_verify_attention(torch.zeros(1, 0, 2, 16),
                                   torch.zeros(2, 16, 1, 16),
                                   torch.zeros(2, 16, 1, 16),
                                   torch.ones(1, 1, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the speculative engine at spec_k_max 8 and 12 against the JAX one
# ---------------------------------------------------------------------------

def _jax_k12_pair(cfg, seed):
    """A JAX target with its second layer's residual write-backs zeroed
    and its first layer as the draft (``golden.spec_k12_params``): the
    draft is accepted at every token, so the draft length climbs to
    ``spec_k_max``, and the verify pass's first layer decides every
    token."""
    target, draft = golden.spec_k12_params(
        golden._flat_params("", jax_build(cfg).init(jax.random.key(seed))))
    return golden._unflat(target), golden._unflat(draft)


@pytest.mark.parametrize("spec_k_max", [8, 12])
def test_spec_streams_equal_jax_engine_past_k1_8(exact_config, spec_k_max,
                                                 monkeypatch):
    """fp32 streams and speculation counters equal the JAX engine's at a
    ``spec_k_max`` the verify kernel took no K1 for before (K1 9 and
    13), and the verify pass runs at a K1 past 8."""
    jcfg = exact_config("tinyllama-1.1b")
    jdcfg = dataclasses.replace(jcfg, num_layers=1)
    target, draft = _jax_k12_pair(jcfg, seed=spec_k_max)
    kw = dict(max_slots=3, max_seq=128, page_size=16, prefill_chunk=16,
              spec_k_max=spec_k_max)
    rng = np.random.default_rng(spec_k_max)
    prompts = [rng.integers(0, 256, size=n) for n in (9, 30, 5)]
    je = JaxEngine(jcfg, params=target, draft_cfg=jdcfg, draft_params=draft,
                   **kw)
    tcfg, tdcfg = (ModelConfig.from_dict(c.to_dict()) for c in (jcfg, jdcfg))
    te = ServingEngine(
        tcfg, params=from_numpy_tree(jax.tree.map(np.asarray, target), tcfg,
                                     "cpu"),
        draft_cfg=tdcfg, draft_params=from_numpy_tree(
            jax.tree.map(np.asarray, draft), tdcfg, "cpu"),
        device="cpu", **kw)
    k1s = []
    plain = tref.paged_verify_attention

    def spy(q, *a, **k):
        k1s.append(q.shape[1])
        return plain(q, *a, **k)

    monkeypatch.setattr(tref, "paged_verify_attention", spy)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new_tokens=48)
    want = [list(r.generated) for r in sorted(je.run_until_drained(),
                                              key=lambda r: r.rid)]
    got = [list(r.generated) for r in sorted(te.run_until_drained(),
                                             key=lambda r: r.rid)]
    assert got == want
    js, ts = je.stats(), te.stats()
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "draft_ticks", "decode_tokens_committed"):
        assert ts[key] == js[key], key
    assert ts["acceptance_rate"] == 1.0
    assert 8 < max(k1s) <= spec_k_max + 1


def test_engine_takes_any_spec_k_max():
    """The engine takes any ``spec_k_max`` from 1, as JAX's does, and
    refuses 0 as JAX's does."""
    from repro.configs import get_reduced_config as jax_reduced
    from repro_torch.configs import get_reduced_config

    cfg = get_reduced_config("tinyllama-1.1b")
    dcfg = dataclasses.replace(cfg, num_layers=1)
    kw = dict(max_slots=2, max_seq=64, seed=1, device="cpu")
    for k in (1, 8, 12, 40):
        assert ServingEngine(cfg, draft_cfg=dcfg, spec_k_max=k,
                             **kw).spec_k_max == k
    jcfg = jax_reduced("tinyllama-1.1b")
    for make, c in ((ServingEngine, cfg), (JaxEngine, jcfg)):
        with pytest.raises(ValueError, match="spec_k_max"):
            extra = kw if make is ServingEngine else dict(max_slots=2,
                                                           max_seq=64)
            make(c, draft_cfg=dataclasses.replace(c, num_layers=1),
                 spec_k_max=0, **extra)


# ---------------------------------------------------------------------------
# the quickstart's model through the weight bridge
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_run_the_jax_examples_model():
    """Both examples build the JAX examples' model: reduced tinyllama, 2
    layers, d_model 64, four heads of 16 over four KV heads."""
    from repro.configs import get_reduced_config as jax_reduced

    want = jax_reduced("tinyllama-1.1b", num_layers=2, d_model=64,
                       head_dim=16, d_ff=128, vocab_size=128)
    for name in ("torch_quickstart", "torch_elastic_restart"):
        cfg = _example(name).model_config()
        assert cfg.to_dict() == want.to_dict(), name
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_) == \
            (4, 4, 16)


def test_quickstart_logits_match_jax(exact_config):
    """The quickstart's model in fp32: ``Model.forward``'s logits through
    the weight bridge within 2e-4 of JAX's, and a decode step's."""
    jcfg = exact_config("tinyllama-1.1b", **golden.QUICKSTART_MODEL)
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(5)), 5)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jm, tm = jax_build(jcfg), Model(tcfg, device="cpu")
    tp = from_numpy_tree(flat, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, flat)
    toks = np.random.default_rng(5).integers(0, 128, (2, 32)) \
        .astype(np.int32)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 32, 128)
    assert _rel(want, got) < 2e-4


# ---------------------------------------------------------------------------
# the fixture's new JAX runs, replayed by the port from the file alone
# ---------------------------------------------------------------------------

def _fixture(pre):
    with np.load(golden.PATH) as f:
        return {k[len(pre):]: f[k] for k in f.files if k.startswith(pre)}


def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return [list(r.generated) for r in sorted(eng.run_until_drained(),
                                              key=lambda r: r.rid)]


def _waves(eng, prompts, max_new):
    """The fixture's two waves (``golden.WAVES``)."""
    for w in (0, 1):
        for p, pw in zip(prompts, golden.WAVES):
            if pw == w:
                eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
    return [list(r.generated) for r in sorted(eng.completed.values(),
                                              key=lambda r: r.rid)]


def test_golden_quickstart_replays_on_the_cpu(tmp_path):
    """``quickstart_*``: the JAX trainer's 3 steps from the drawn step-0
    parameters (losses, grad norms and final parameters within 1e-4),
    then the JAX engine's streams from the trained parameters and its
    first-token logits within 2e-4."""
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.launch import programs
    from repro_torch.optim import adamw, schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path

    f = _fixture("")
    g = {k[len("quickstart_"):]: v for k, v in f.items()
         if k.startswith("quickstart_")}
    cfg = ModelConfig.from_dict(json.loads(str(g["train_config"])))
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_) == (4, 4, 16)
    setup = json.loads(str(g["train_setup"]))

    def tree(flat):
        return from_numpy_tree(unflatten(flat), cfg, "cpu")

    def part(prefix):
        return {k[len(prefix):]: v for k, v in g.items()
                if k.startswith(prefix)}

    ck.save(str(tmp_path), 0, {"params": tree(golden.draw(
        str(g["train_params0_spec"]), int(g["train_params0_seed"]))),
        "opt": {"step": torch.tensor(0, dtype=torch.int32),
                "m": tree(part("train_opt0/m/")),
                "v": tree(part("train_opt0/v/"))}}, {"step": 0})
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    tr = Trainer(cfg, "cpu", tcfg, TrainerConfig(ckpt_dir=str(tmp_path),
                                                 ckpt_every=0))
    tr.initialize(restore=True)
    data = make_lm_iterator(cfg, setup["batch"], setup["seq"],
                            seed=setup["seed"])
    ms = [tr.train_step(next(data)) for _ in range(setup["steps"])]
    np.testing.assert_allclose([m["loss"] for m in ms], g["train_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in ms],
                               g["train_grad_norms"], rtol=1e-4)
    final = tree(part("train_final/"))
    want = dict(flatten_with_path(final))
    for path, p in flatten_with_path(tr.params):
        np.testing.assert_allclose(p.detach().numpy(), want[path].numpy(),
                                   rtol=0, atol=1e-4)
    eng = ServingEngine(cfg, params=final, device="cpu",
                        **json.loads(str(f["engine"])))
    prompts = [p[:n] for p, n in zip(g["prompts"], f["prompt_lens"])]
    assert _waves(eng, prompts, golden.MAX_NEW) == g["streams"].tolist()
    with torch.no_grad():
        for p, w in zip(prompts, g["first_logits"]):
            lg = eng.model.forward(final, {"tokens": torch.from_numpy(
                p[None].astype(np.int64))})[0, -1]
            assert _rel(w, lg) < 2e-4


def test_golden_deepseek_reduced_replays_on_the_cpu():
    """``deepseek_reduced_*``: reduced deepseek at its default MLA widths
    (latent keys of 48 over values of 32 at G 4), parameters drawn from
    the stored spec; the port gives the warmed JAX engine's streams and
    last-position logits within 2e-4."""
    g = _fixture("deepseek_reduced_")
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    m = cfg.mla
    assert (m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank,
            cfg.num_heads) == (48, 32, 4)
    params = from_numpy_tree(unflatten(golden.draw(
        str(g["params_spec"]), int(g["params_seed"]))), cfg, "cpu")
    eng = ServingEngine(cfg, params=params, device="cpu",
                        **json.loads(str(g["engine"])))
    prompts = [p[:n] for p, n in zip(g["prompts"], g["prompt_lens"])]
    assert _drain(eng, prompts, int(g["max_new"])) == g["streams"].tolist()
    with torch.no_grad():
        for p, w in zip(prompts, g["last_logits"]):
            lg = eng.model.forward(params, {"tokens": torch.from_numpy(
                p[None].astype(np.int64))})[0, -1]
            assert _rel(w, lg) < 2e-4


def test_golden_spec_k12_replays_on_the_cpu():
    """``spec_k12_*``: the fixture's target with its second layer's
    write-backs zeroed and its first layer as the draft, at
    ``spec_k_max`` 12: the JAX engine's streams and speculation
    counters."""
    f = _fixture("")
    setup = json.loads(str(f["spec_k12_setup"]))
    cfg = ModelConfig.from_dict(json.loads(str(f["config"])))
    target, draft = golden.spec_k12_params(
        {k[len("params/"):]: v for k, v in f.items()
         if k.startswith("params/")})
    dcfg = dataclasses.replace(cfg, num_layers=1)
    eng = ServingEngine(
        cfg, params=from_numpy_tree(unflatten(target), cfg, "cpu"),
        draft_cfg=dcfg, draft_params=from_numpy_tree(unflatten(draft), dcfg,
                                                     "cpu"),
        spec_k_max=setup["spec_k_max"], device="cpu", **setup["engine"])
    prompts = [p[:n] for p, n in zip(f["prompts"], f["prompt_lens"])]
    assert _waves(eng, prompts, setup["max_new"]) == \
        f["spec_k12_streams"].tolist()
    st = eng.stats()
    assert {k: st[k] for k in ("spec_rounds", "spec_proposed",
                               "spec_accepted")} == \
        json.loads(str(f["spec_k12_stats"]))

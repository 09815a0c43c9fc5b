"""The port's plain attention versions against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels run in interpret mode, on
the same inputs made from a numpy seed.  The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.

Tolerances are the JAX suite's (``tests/test_kernels.py:15``): 2e-5 for
float32 and 3.5e-2 for bfloat16, relative to the largest output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged
from repro.models.attention import _quantize as jax_quantize
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import _quantize as torch_quantize
from test_torch_gpu import FLASH_CASES, PAGED_CASES

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-5 if name == "float32" else 3.5e-2


def _rel_err(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _pair(x, name):
    """The same values in both frameworks (bf16 rounding is identical)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t):
    return t.float().numpy()


def _flash_inputs(case, seed):
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D), np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D), np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D), np.float32)
    vl = rng.integers(1, Tk + 1, size=(B,)).astype(np.int32) if valid else None
    return q, k, v, vl


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax_ref_and_pallas(case, dtype):
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid = case
    q, k, v, vl = _flash_inputs(case, seed=B * 131 + Tq)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = tref.mha(tq, tk, tv, kv_valid_len=None if vl is None
                   else torch.from_numpy(vl), **kw)
    jvl = None if vl is None else jnp.asarray(vl)
    want = jref.mha(jq, jk, jv, kv_valid_len=jvl, **kw)
    assert got.dtype == tq.dtype
    assert _rel_err(want, _np(got)) < _tol(dtype)
    pallas = pallas_flash(jq, jk, jv, kv_valid_len=jvl, interpret=True,
                          block_q=32, block_k=32, **kw)
    assert _rel_err(pallas, _np(got)) < _tol(dtype)


def test_mha_explicit_positions_and_empty_rows():
    """Chunk-style call: queries at an offset over a longer key span with
    ``kv_valid_len``; a batch row with ``kv_valid_len = 0`` (the engine's
    warmup chunks) is fully masked and must give 0, not NaN — as the
    Pallas kernel does."""
    B, T, S, Hq, Hkv, D = 2, 16, 64, 4, 2, 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, T, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    qpos = (np.arange(T)[None] + np.array([[20], [0]])).astype(np.int32)
    valid = np.array([36, 0], np.int32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              q_positions=torch.from_numpy(qpos),
                              kv_valid_len=torch.from_numpy(valid))
    kvpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_positions=jnp.asarray(qpos),
                          kv_positions=jnp.asarray(kvpos),
                          kv_valid_len=jnp.asarray(valid), interpret=True,
                          block_q=16, block_k=32)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.all(got[1] == 0.0)
    assert _rel_err(pallas, got) < 2e-5
    want = jref.mha(jnp.asarray(q[:1]), jnp.asarray(k[:1]), jnp.asarray(v[:1]),
                    q_positions=jnp.asarray(qpos[:1]),
                    kv_positions=jnp.asarray(kvpos[:1]),
                    kv_valid_len=jnp.asarray(valid[:1]))
    assert _rel_err(want, got[:1]) < 2e-5


def _paged_inputs(case, seed, int8=False):
    B, Hq, Hkv, D, page, MP, P, window, softcap = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    table = rng.integers(0, P, size=(B, MP)).astype(np.int32)
    clen = rng.integers(1, MP * page + 1, size=(B,)).astype(np.int32)
    return q, kp, vp, table, clen


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax_ref_and_pallas(case, dtype):
    B, Hq, Hkv, D, page, MP, P, window, softcap = case
    q, kp, vp, table, clen = _paged_inputs(case, seed=B * 31 + MP)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    kw = dict(window=window, softcap=softcap)
    got = tref.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                      torch.from_numpy(clen), **kw)
    want = jref.paged_decode_attention(jq, jk, jv, jnp.asarray(table),
                                       jnp.asarray(clen), **kw)
    assert got.dtype == tq.dtype
    assert _rel_err(want, _np(got)) < _tol(dtype)
    pallas = pallas_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(clen),
                          interpret=True, **kw)
    assert _rel_err(pallas, _np(got)) < _tol(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_int8_scales(dtype):
    """int8 pools quantized by each package's own ``_quantize``: the port
    quantizes to the same integers and scales, and its plain version
    matches the JAX oracle and the scale-folding Pallas kernel."""
    case = (2, 8, 2, 64, 16, 4, 11, 0, 30.0)
    B, Hq, Hkv, D, page, MP, P, window, softcap = case
    q, kp, vp, table, clen = _paged_inputs(case, seed=17)
    jkq, jks = jax_quantize(jnp.asarray(kp))
    jvq, jvs = jax_quantize(jnp.asarray(vp))
    tkq, tks = torch_quantize(torch.from_numpy(kp))
    tvq, tvs = torch_quantize(torch.from_numpy(vp))
    np.testing.assert_array_equal(np.asarray(jkq), tkq.numpy())
    np.testing.assert_array_equal(np.asarray(jvq), tvq.numpy())
    np.testing.assert_allclose(np.asarray(jks), tks.numpy(), rtol=1e-7)
    jq, tq = _pair(q, dtype)
    got = tref.paged_decode_attention(
        tq, tkq, tvq, torch.from_numpy(table), torch.from_numpy(clen),
        softcap=softcap, k_scale=tks, v_scale=tvs)
    kw = dict(softcap=softcap, k_scale=jks, v_scale=jvs)
    want = jref.paged_decode_attention(jq, jkq, jvq, jnp.asarray(table),
                                       jnp.asarray(clen), **kw)
    assert _rel_err(want, _np(got)) < _tol(dtype)
    pallas = pallas_paged(jq, jkq, jvq, jnp.asarray(table),
                          jnp.asarray(clen), interpret=True, **kw)
    assert _rel_err(pallas, _np(got)) < _tol(dtype)


def test_paged_decode_empty_row_and_stale_rows():
    """``cache_len = 0`` gives 0 like the Pallas kernel (the JAX oracle
    averages the masked row instead), and huge stale values in a page row
    past ``cache_len`` never reach the output: probabilities are masked,
    not only the logits, so 0·x stays 0."""
    case = (2, 4, 2, 32, 16, 4, 9, 0, 0.0)
    q, kp, vp, table, clen = _paged_inputs(case, seed=3)
    table[1] = [1, 2, 3, 4]
    clen[:] = [0, 20]
    vp[2, 4:] = 1e30                         # row 1: positions 20..31
    kp[2, 4:] = 1e30
    got = tref.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(clen)).numpy()
    assert np.isfinite(got).all()
    assert np.all(got[0] == 0.0)
    pallas = pallas_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(table), jnp.asarray(clen),
                          interpret=True)
    assert _rel_err(pallas, got) < 2e-5
    want = jref.paged_decode_attention(
        jnp.asarray(q[1:]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table[1:]), jnp.asarray(clen[1:]))
    assert _rel_err(want, got[1:]) < 2e-5


def test_wrappers_take_the_plain_path_only_on_cpu():
    """On CPU tensors ``ops`` runs the plain version and never counts a
    launch; the kernel wrappers refuse CPU tensors outright."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    before = (fa.flash_attention.launches, pda.paged_decode_attention.launches)
    q = torch.zeros(1, 4, 2, 32)
    ops.flash_attention(q, q, q)
    assert (fa.flash_attention.launches,
            pda.paged_decode_attention.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        pda.paged_decode_attention(torch.zeros(1, 2, 32),
                                   torch.zeros(2, 16, 1, 32),
                                   torch.zeros(2, 16, 1, 32),
                                   torch.zeros(1, 1, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))

"""The port's model layers and dense decoder against the JAX package, on
the same weights (through the weight bridge) and the same numpy inputs.

Model-level bound: 2e-4 of the largest logit, the bound of
``tests/test_decode_consistency.py:42``, under the fp32 ``exact_config``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.config import ModelConfig as JConfig
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, to_numpy_tree

torch.set_num_threads(1)


def _rel(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _tcfg(jcfg: JConfig) -> ModelConfig:
    return ModelConfig.from_dict(jcfg.to_dict())


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_dict_round_trip_and_reduced():
    from repro.configs import get_config as jget
    from repro.models.config import reduced as jreduced
    from repro_torch.models.config import reduced as treduced

    jcfg = jget("tinyllama-1.1b")
    tcfg = get_config("tinyllama-1.1b")
    assert tcfg.to_dict() == jcfg.to_dict()
    assert ModelConfig.from_dict(jcfg.to_dict()) == tcfg
    assert JConfig.from_dict(tcfg.to_dict()) == jcfg
    assert treduced(tcfg).to_dict() == jreduced(jcfg).to_dict()
    assert tcfg.head_dim_ == jcfg.head_dim_ == 64
    assert tcfg.q_groups == jcfg.q_groups == 8
    assert tcfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    assert tcfg.cdtype == torch.bfloat16 and tcfg.pdtype == torch.float32
    # every registered arch is ported (deepseek-v2-236b the last); an
    # unknown name raises
    from repro.configs import list_archs

    for arch in list_archs():
        assert get_config(arch).to_dict() == jget(arch).to_dict()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    """The model norm: f32 statistics, products in the compute dtype."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    s = 1 + 0.1 * rng.standard_normal((64,), np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = jl.rms_norm_simple(jnp.asarray(x, jdt), jnp.asarray(s), 1e-5)
    got = tl.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s), 1e-5)
    assert got.dtype == tdt
    tol = 2e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.float().numpy(), rtol=tol, atol=tol)


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32), np.float32)
    pos = rng.integers(0, 1000, size=(2, 7)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(np.asarray(want), got.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches(act):
    jcfg = JConfig(d_model=32, d_ff=64, activation=act, mlp_bias=True,
                   compute_dtype="float32")
    p = jl.init_mlp(jax.random.key(0), jcfg)
    p = jax.tree.map(lambda a: a + 0.1, p)            # nonzero biases
    x = np.random.default_rng(2).standard_normal((3, 32), np.float32)
    want = jl.apply_mlp(p, jnp.asarray(x), jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, p), _tcfg(jcfg), "cpu")
    got = tl.apply_mlp(tp, torch.from_numpy(x), _tcfg(jcfg))
    np.testing.assert_allclose(np.asarray(want), got.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tie", [False, True])
def test_embedding_and_lm_head_match(tie):
    """Embedding with ``embed_scale`` (rounded to bf16 like JAX) and the
    LM head, tied or not, with a final softcap."""
    jcfg = JConfig(d_model=32, vocab_size=50, embed_scale=True,
                   tie_embeddings=tie, final_logit_softcap=30.0,
                   compute_dtype="bfloat16")
    tcfg = _tcfg(jcfg)
    emb = jl.init_embedding(jax.random.key(0), jcfg)
    head = jl.init_lm_head(jax.random.key(1), jcfg)
    toks = np.random.default_rng(3).integers(0, 50, size=(2, 6))
    we = jl.apply_embedding(emb, jnp.asarray(toks), jcfg)
    te_p = from_numpy_tree(jax.tree.map(np.asarray, emb), tcfg, "cpu")
    th_p = None if head is None else \
        from_numpy_tree(jax.tree.map(np.asarray, head), tcfg, "cpu")
    ge = tl.apply_embedding(te_p, torch.from_numpy(toks), tcfg)
    np.testing.assert_array_equal(np.asarray(we, np.float32),
                                  ge.float().numpy())
    wl = jl.apply_lm_head(emb, head, we, jcfg)
    gl = tl.apply_lm_head(te_p, th_p, ge, tcfg)
    assert _rel(wl, gl.float().numpy()) < 3.5e-2


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip(exact_config, pdtype):
    jcfg = exact_config("tinyllama-1.1b", param_dtype=pdtype)
    jp = jax_build(jcfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = from_numpy_tree(tree, _tcfg(jcfg), "cpu")
    # same names and stacked [L, ...] layouts as the port's own init
    own = Model(_tcfg(jcfg), device="cpu").init(torch.Generator().manual_seed(0))
    flat = lambda t: {"/".join(map(str, k)): v for k, v in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    shapes = {k: tuple(v.shape) for k, v in flat(tp).items()}
    assert shapes == {k: tuple(v.shape) for k, v in flat(own).items()}
    for k, v in flat(tp).items():
        assert v.dtype == _tcfg(jcfg).pdtype
    back = to_numpy_tree(tp)
    for (k, a), (_, b) in zip(sorted(flat(tree).items()),
                              sorted(flat(back).items())):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


# ---------------------------------------------------------------------------
# whole model, fp32 reduced tinyllama
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(exact_config):
    jcfg = exact_config("tinyllama-1.1b")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(1))
    tcfg = _tcfg(jcfg)
    tm = Model(tcfg, device="cpu")
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def test_forward_logits_match(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 24))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, jcfg.vocab_size)
    assert _rel(want, got.numpy()) < 2e-4


def test_chunked_paged_prefill_and_decode_match(pair):
    """Two rows of different lengths stream in two 16-token chunks (the
    second right-padded) into scrambled pages, then decode four tokens:
    every step's logits match JAX's ``prefill_chunk``/``decode_paged``."""
    jcfg, jm, jp, tcfg, tm, tp = pair
    page, MP, P = 8, 6, 16
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    table = np.zeros((2, MP), np.int32)
    table[0] = [3, 9, 1, 14, 6, 11]
    table[1] = [2, 12, 5, 8, 15, 4]
    jpool = jm.init_paged_caches(P, page, dtype=jnp.float32)
    tpool = tm.init_paged_caches(P, page, dtype=torch.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    lens = np.array([28, 20], np.int32)
    errs = []
    with torch.no_grad():
        for s in (0, 16):
            start = np.array([s, s], np.int32)
            new = np.minimum(lens, s + 16).astype(np.int32)
            jl_, jpool = jm.prefill_chunk(
                jp, {"tokens": jnp.asarray(toks[:, s:s + 16])}, jpool,
                jnp.asarray(start), jnp.asarray(new), page_table=jt)
            tl_ = tm.prefill_chunk(
                tp, {"tokens": torch.from_numpy(toks[:, s:s + 16])}, tpool,
                torch.from_numpy(start), torch.from_numpy(new),
                page_table=tt)
            errs.append(_rel(jl_, tl_.numpy()))
        clen = lens.copy()
        nxt = np.asarray(jnp.argmax(jl_, -1)).astype(np.int32)
        for _ in range(4):
            jl_, jpool = jm.decode_paged(jp, jnp.asarray(nxt), jpool, jt,
                                         jnp.asarray(clen))
            tl_ = tm.decode_paged(tp, torch.from_numpy(nxt), tpool, tt,
                                  torch.from_numpy(clen))
            errs.append(_rel(jl_, tl_.numpy()))
            nxt = np.asarray(jnp.argmax(jl_, -1)).astype(np.int32)
            clen = clen + 1
    assert max(errs) < 2e-4, errs
    # the pools hold the same KV, page for page (trash page 0 aside)
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jpool["attn"][name])[:, 1:],
                                   tpool["attn"][name].numpy()[:, 1:],
                                   rtol=1e-4, atol=1e-5)


def test_full_width_config_builds_without_weights():
    """The full tinyllama config passes the port's family checks and its
    paged cache tree has the JAX layout [L, P, page, Hkv, D]."""
    from repro_torch.models.transformer import init_paged_cache_tree

    cfg = get_config("tinyllama-1.1b")
    pools = init_paged_cache_tree(cfg, 3, 16, torch.bfloat16, "cpu")
    assert tuple(pools["attn"]["k"].shape) == (22, 3, 16, 4, 64)
    red = get_reduced_config("tinyllama-1.1b")
    assert red.num_layers == 2 and red.vocab_size == 256

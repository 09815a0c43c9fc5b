"""The layouts the JAX package builds outside its registered configs, in
the port, against JAX on the CPU (reduced configs, fp32).

- ``check_ported`` refuses only what JAX itself cannot build, and each
  refusal names JAX's own failure: JAX is run into each one here.
- Every other layout builds and trains as in JAX: a full-attention MoE
  (mixtral-8x7b without its window, with and without a leading dense
  layer), leading dense layers beside sliding-window attention, a window
  or MLA in the dense decoder and the hybrid, a window over full
  attention (a ring with no window mask in prefill), encoders with
  RMSNorm, over token ids, causal or windowed, a dense encoder-only
  model, a decoder over ``audio_frames`` features, and attention of type
  "none" outside the ssm family.  Logits within 2e-4 relative
  (``tests/test_decode_consistency.py:42``), every gradient within 2e-5
  of ``jax.grad``'s relative to its leaf's largest value.
- The layouts that serve on dense slots in JAX give the JAX engine's
  greedy streams, byte for byte, encoder-only models over token ids
  included (an encoder over ``audio_frames`` serves through a
  container's ``generic`` entry point).
- Neither package serves attention of type "none" (no cache leaf; the
  port refuses it at construction, naming JAX's failure) nor a decoder
  over features (the engine feeds token ids: both fail on the missing
  key)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.configs import get_reduced_config as jax_reduced
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree
from repro_torch.optim import grad as gradlib
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import flatten_with_path, leaves

torch.set_num_threads(1)

LOGIT_TOL = 2e-4
GRAD_TOL = 2e-5


def _f32(arch, **over):
    return dataclasses.replace(jax_reduced(arch), compute_dtype="float32",
                               **over)


def _layouts():
    mix, ds = jax_reduced("mixtral-8x7b"), jax_reduced("deepseek-v2-236b")
    fd = dataclasses.replace(mix.moe, first_dense_layers=1,
                             first_dense_d_ff=256)
    return {
        "moe_full": _f32("mixtral-8x7b", attn_type="full",
                         sliding_window=0),
        "moe_full_dense_first": _f32("mixtral-8x7b", attn_type="full",
                                     sliding_window=0, moe=fd),
        "moe_swa_dense_first": _f32("mixtral-8x7b", moe=fd),
        "moe_full_ring": _f32("mixtral-8x7b", attn_type="full"),
        "moe_mla_ring": _f32("deepseek-v2-236b", sliding_window=16),
        "moe_swa_no_window": _f32("mixtral-8x7b", sliding_window=0),
        "dense_swa": _f32("tinyllama-1.1b", attn_type="swa",
                          sliding_window=16),
        "dense_full_ring": _f32("tinyllama-1.1b", sliding_window=16),
        "dense_mla": _f32("tinyllama-1.1b", attn_type="mla", mla=ds.mla),
        "hybrid_swa": _f32("zamba2-1.2b", attn_type="swa",
                           sliding_window=16),
        "hybrid_full_ring": _f32("zamba2-1.2b", sliding_window=16),
        "hybrid_mla": _f32("zamba2-1.2b", attn_type="mla", mla=ds.mla),
        "encoder_rmsnorm": _f32("edge-cv-heavy", norm="rmsnorm"),
        "encoder_tokens": _f32("edge-cv-heavy", frontend="none"),
        "encoder_causal": _f32("edge-cv-heavy", encoder_only=False),
        "encoder_swa": _f32("edge-cv-heavy", attn_type="swa",
                            sliding_window=8),
        "dense_encoder_only": _f32("tinyllama-1.1b", encoder_only=True),
        "dense_audio_frames": _f32("tinyllama-1.1b",
                                   frontend="audio_frames", frontend_dim=64),
        "dense_attn_none": _f32("tinyllama-1.1b", attn_type="none"),
    }


LAYOUTS = _layouts()
# the layouts the JAX engine serves on dense slots (the full-attention
# MoE pages: tests/test_torch_moe_paged.py)
SLOT_LAYOUTS = ["moe_swa_dense_first", "moe_full_ring", "moe_mla_ring",
                "moe_swa_no_window", "dense_swa", "dense_full_ring",
                "dense_mla", "hybrid_swa", "hybrid_full_ring", "hybrid_mla",
                "encoder_tokens", "dense_encoder_only"]


def _pair(name, seed=0):
    jcfg = LAYOUTS[name]
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(seed)), seed)
    return (jcfg, jax.tree.map(jnp.asarray, flat), tcfg,
            from_numpy_tree(flat, tcfg, "cpu"))


def _rel(want, got) -> float:
    w = np.asarray(want, np.float32)
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32)
    return float(np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6))


def _batch(cfg, B=2, T=24, seed=0):
    """A training batch for ``cfg``: features or tokens, and targets with
    a mask (an encoder) or labels (a decoder)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        b = {"features": rng.normal(size=(B, T, cfg.frontend_dim))
             .astype(np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T))}
    ids = rng.integers(0, cfg.vocab_size, (B, T))
    if cfg.encoder_only:
        b["targets"] = ids
        b["mask"] = rng.random((B, T)) < 0.5
    else:
        ids[:, :2] = -1
        b["labels"] = ids
    return b


# ---------------------------------------------------------------------------
# what stays refused: JAX's own failures
# ---------------------------------------------------------------------------

def _jax_fails(jcfg, batch):
    """Build JAX's model and run its loss: the exception it raises."""
    with pytest.raises(Exception) as info:
        model = jax_build(jcfg)
        model.loss(model.init(jax.random.key(0)),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    return info.value


REFUSED = [
    ("moe_without_moe", dict(family="moe"), AttributeError,
     "first_dense_layers", "moe=None"),
    ("mla_without_mla", dict(attn_type="mla"), AttributeError,
     "no attribute", "mla=None"),
    ("moe_parallel_block", "moe_parallel", KeyError, "mlp",
     "KeyError 'mlp'"),
    ("unknown_family", dict(family="retnet"), ValueError, "retnet",
     "ValueError"),
    ("hybrid_without_ssm", "hybrid_no_ssm", AssertionError, "",
     "AssertionError"),
]


@pytest.mark.parametrize("name, over, exc, jax_msg, port_msg", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_refusals_name_jax_own_failure(name, over, exc, jax_msg, port_msg):
    if over == "moe_parallel":
        jcfg = _f32("mixtral-8x7b", parallel_block=True)
    elif over == "hybrid_no_ssm":
        jcfg = _f32("zamba2-1.2b", ssm=None)
    else:
        jcfg = _f32("tinyllama-1.1b", **over)
    err = _jax_fails(jcfg, _batch(jcfg))
    assert isinstance(err, exc) and jax_msg in str(err), repr(err)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    with pytest.raises(NotImplementedError, match=port_msg):
        check_ported(tcfg)
    with pytest.raises(NotImplementedError, match="JAX"):
        Model(tcfg, "cpu")


def test_paged_pools_need_full_attention_in_both_packages():
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg = LAYOUTS["dense_swa"]
    with pytest.raises(AssertionError):
        jattn.init_paged_pool(jcfg, 4, 16, jnp.float32)
    with pytest.raises(NotImplementedError, match="asserts attn_type"):
        tattn.init_paged_pool(ModelConfig.from_dict(jcfg.to_dict()), 4, 16,
                              torch.float32, "cpu")


def test_layouts_neither_package_serves():
    """Attention of type "none" keeps no cache: the JAX engine fails at
    its first prefill on the missing ``k``, the port's refuses at
    construction, naming that.  A model over features gets token ids from
    either engine: both fail at their first prefill on the missing
    ``features``."""
    jcfg, jp, tcfg, tp = _pair("dense_attn_none")
    kw = dict(max_slots=2, max_seq=32)
    with pytest.raises(KeyError, match="'k'"):
        JaxEngine(jcfg, params=jp, **kw).warmup()
    with pytest.raises(NotImplementedError, match="KeyError 'k'"):
        ServingEngine(tcfg, params=tp, device="cpu", **kw)
    jcfg, jp, tcfg, tp = _pair("dense_audio_frames")
    with pytest.raises(KeyError) as want:
        JaxEngine(jcfg, params=jp, **kw).warmup()
    with pytest.raises(KeyError) as got:
        ServingEngine(tcfg, params=tp, device="cpu", **kw).warmup()
    assert got.value.args == want.value.args == ("features",)


# ---------------------------------------------------------------------------
# every other layout: logits and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_logits_and_gradients_match_jax(name):
    jcfg, jp, tcfg, tp = _pair(name, seed=2)
    check_ported(tcfg)
    batch = _batch(jcfg, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build(jcfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jp, jb)
    want_logits, want_aux = jmodel.forward(jp, jb)
    model = Model(tcfg, "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = model.forward_with_aux(tp, tb)
    assert _rel(want_logits, logits) < LOGIT_TOL
    assert abs(float(aux) - float(want_aux)) <= LOGIT_TOL * abs(
        float(want_aux)) + 1e-7
    params = tp
    for p in leaves(params):
        p.requires_grad_(True)
    (loss, m), grads = gradlib.accumulate_grads(
        model.loss, params, tb, 1, unread=model.unread_leaves())
    for key in ("loss", "ce", "aux"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            LOGIT_TOL * abs(float(jm[key])) + 1e-7, key
    want = {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    got = {p: x.detach().float().numpy() for p, x in flatten_with_path(grads)}
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        if not np.abs(w).max():
            assert not np.abs(got[path]).max(), path
            continue
        assert _rel(w, got[path]) < GRAD_TOL, (path, _rel(w, got[path]))


# ---------------------------------------------------------------------------
# the dense-slot layouts: engine streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SLOT_LAYOUTS)
def test_slot_layout_streams_equal_jax_engine(name):
    """Prompts longer than the rings of 16, on 2 slots; both engines
    warmed first (the JAX slot tree turns fp32 at its first decode).  The
    windowed and hybrid layouts prefill each prompt whole at its exact
    length, the rest in a pow2 bucket, as in JAX; an encoder-only model
    over token ids attends over the whole bucket, pad tokens included, as
    JAX's does."""
    jcfg, jp, tcfg, tp = _pair(name, seed=1)
    kw = dict(max_slots=2, max_seq=64, prefill_chunk=16)
    je = JaxEngine(jcfg, params=jp, **kw).warmup()
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw).warmup()
    assert not je.paged and not te.paged
    assert te._stateful == je._stateful
    assert te._chunkable_stateful == je._chunkable_stateful is False
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n) for n in (20, 37, 9, 50)]
    out = []
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        eng.run_until_drained()
        assert not eng.failed
        out.append([list(r.generated) for r in
                    sorted(eng.completed.values(), key=lambda r: r.rid)])
    assert out[0] == out[1] and all(len(s) == 8 for s in out[1])
    assert te.stats()["prefill_chunks"] == len(prompts)

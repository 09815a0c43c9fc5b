"""MoE training and the flash backward at the wide head dims, in the port
against the JAX package, on the CPU, on the same inputs made from numpy
seeds:

- the plain ``ref.flash_attention_bwd`` against the Pallas dq and dk/dv
  kernels (interpret mode) at (key, value) head dims (192, 192),
  (256, 256), (192, 128) and (48, 32), causal with a ragged valid length
  and with a softcap, and (192, 128) with G > 1; ``flash_mha``'s gradients there
  against ``jax.grad`` of the JAX ``flash_mha``;
- the MoE layer's gradients (``dL/dx``, the router, the experts, the
  shared experts, and the aux term's share alone) against ``jax.grad``
  of ``_apply_moe_local``, for reduced mixtral and DeepSeek at capacity
  factors 1.25 and 0.25, the latter with dropped pairs written into slot
  ``n_pairs + 1`` inside the buffer;
- ``Model.loss`` and every gradient leaf of reduced mixtral (window 32
  under a longer batch), DeepSeek at the published MLA widths (the dense
  block and the MoE block), gemma-2b at head dim 256 and nemotron-4-340b
  at head dim 192, in the fp32 ``exact_config``;
- three ``build_train_step`` steps of mixtral and DeepSeek (also with
  int8 AdamW moments) against JAX's: losses, ``ce``, ``aux``, grad
  norms and parameters; the int8 update done in chunks of whole
  quantization blocks equal to one pass over the leaf, bit for bit;
- ``Trainer`` on reduced mixtral through a checkpoint restart, and
  ``launch/train.py --arch deepseek-v2-236b --reduced --device cpu``,
  also through a restart;
- the golden fixture's ``*_train_*`` runs, rebuilt from JAX equal to the
  committed file and replayed by the port's ``Trainer``.

Tolerances: 2e-5 (fp32) relative to the largest value for the kernels
and the MoE layer (``tests/test_kernels.py:15``); 2e-4 relative per
gradient leaf through a model's loss (``tests/test_decode_consistency.py
:42``); 2e-4 for losses, grad norms and parameters after 3 steps and
for the golden replays (the replay on the card holds losses to 2e-5).
About 2 minutes alone, most of it JAX compiling.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.configs import get_reduced_config as jax_reduced
from repro.data.tokens import make_lm_iterator as jax_lm_iterator
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as pallas_bwd
from repro.kernels.flash_attention_bwd import flash_mha as jax_flash_mha
from repro.launch import programs as jprograms
from repro.models import moe as jmoe
from repro.models.config import MLAConfig
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw, schedule as jsched
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import make_lm_iterator
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention_bwd import flash_mha
from repro_torch.launch import programs
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.optim import adamw, grad as gradlib, schedule
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, leaves

torch.set_num_threads(1)

TOL = 2e-5
GRAD_TOL = 2e-4
STEP_TOL = 2e-4
OPT = dict(adamw=dict(lr=3e-3, grad_clip_norm=1.0),
           sched=dict(warmup_steps=2, decay_steps=200))


def _rel(want, got) -> float:
    w = np.asarray(want, np.float32)
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32)
    return float(np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6))


def _flat(tree):
    """``{keystr: numpy}`` of a JAX or a torch tree."""
    if isinstance(jax.tree.leaves(tree)[0], jax.Array):
        return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {p: x.detach().float().numpy().copy()
            for p, x in flatten_with_path(tree)}


def _port_params(jparams, cfg):
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# the flash backward at the wide head dims
# ---------------------------------------------------------------------------

# B, T, Hq, Hkv, Dk, Dv, causal, softcap, ragged: each pair causal with a
# ragged valid length (batch row 0 sees no key, row 1 its first T - 5)
# and causal with a softcap, then (192, 128) at G 2 and non-causal at G 4,
# and the reduced DeepSeek config's (48, 32), which its launcher trains
WIDE_CASES = [
    (2, 32, 2, 2, 192, 192, True, 0.0, True),
    (1, 32, 2, 1, 192, 192, True, 20.0, False),
    (2, 32, 2, 2, 256, 256, True, 0.0, True),
    (1, 32, 2, 1, 256, 256, True, 20.0, False),
    (2, 32, 2, 2, 192, 128, True, 0.0, True),
    (1, 32, 2, 2, 192, 128, True, 20.0, False),
    (2, 32, 4, 2, 192, 128, True, 0.0, True),
    (1, 32, 4, 1, 192, 128, False, 0.0, False),
    (2, 32, 4, 2, 48, 32, True, 0.0, True),
    (1, 32, 4, 4, 48, 32, True, 20.0, False),
]


def _wide_inputs(case, seed):
    B, T, Hq, Hkv, Dk, Dv, causal, softcap, ragged = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s, np.float32) for s in (
        (B, T, Hq, Dk), (B, T, Hkv, Dk), (B, T, Hkv, Dv), (B, T, Hq, Dv)))
    pos = {}
    if ragged:
        pos["kv_valid_len"] = np.array([0] + [T - 5] * (B - 1), np.int32)
    return (q, k, v, do), dict(causal=causal, softcap=softcap), pos


@pytest.mark.parametrize("case", WIDE_CASES)
def test_plain_bwd_matches_pallas_at_wide_dims(case):
    """``ref.flash_attention_bwd`` against the Pallas dq and dk/dv kernels
    (interpret mode) on the same q, k, v, out, lse and do, fp32: dq and
    dk as wide as the keys, dv as the values."""
    (q, k, v, do), kw, pos = _wide_inputs(case, seed=sum(case[:6]))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jpos = {n: jnp.asarray(x) for n, x in pos.items()}
    out, lse = pallas_flash(jq, jk, jv, return_lse=True, interpret=True,
                            block_q=16, block_k=16, **kw, **jpos)
    want = pallas_bwd(jq, jk, jv, out, lse, jdo, interpret=True,
                      block_q=16, block_k=16, **kw, **jpos)
    tout, tlse = tref.mha(*(torch.from_numpy(x) for x in (q, k, v)),
                          return_lse=True, **kw,
                          **{n: torch.from_numpy(x) for n, x in pos.items()})
    assert _rel(out, tout) < TOL
    live = np.asarray(lse) > tref.NEG_INF
    assert _rel(np.asarray(lse)[live], tlse.numpy()[live]) < TOL
    got = tref.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), **kw,
        **{n: torch.from_numpy(x) for n, x in pos.items()})
    B, T, Hq, Hkv, Dk, Dv = case[:6]
    for name, w, g, shape in zip(("dq", "dk", "dv"), want, got,
                                 ((B, T, Hq, Dk), (B, T, Hkv, Dk),
                                  (B, T, Hkv, Dv))):
        assert tuple(g.shape) == tuple(w.shape) == shape, name
        assert np.isfinite(g.numpy()).all(), name
        assert _rel(w, g) < TOL, (name, _rel(w, g))
    if pos:                          # the row that sees no key: no gradient
        assert not got[0][0].any() and got[0][1].any()


@pytest.mark.parametrize("case", [c for c in WIDE_CASES if not c[-1]])
def test_flash_mha_grads_match_jax_flash_mha_at_wide_dims(case):
    """Gradients of ``sum(cos(flash_mha(q, k, v)))`` on the CPU against
    ``jax.grad`` of the JAX ``flash_mha`` (its Pallas forward and
    backward in interpret mode)."""
    (q, k, v, _), kw, _ = _wide_inputs(case, seed=case[4] + case[5])
    want = jax.grad(lambda *a: jnp.sum(jnp.cos(jax_flash_mha(
        *a, kw["causal"], 0, kw["softcap"], 16, 16, True))),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(torch.cos(flash_mha(*ts, **kw)).sum(), ts)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.shape == w.shape, name
        assert _rel(w, g) < TOL, (name, _rel(w, g))


# ---------------------------------------------------------------------------
# the MoE layer's gradients
# ---------------------------------------------------------------------------

# arch, capacity factor, tokens: at 1.25 crowded inputs drop pairs into
# slot n_pairs + 1 = 129 of 160; at 0.25 the buffer's floor of 8 rows an
# expert keeps slot 25 inside 32 for 12 tokens
MOE_GRAD_CASES = [("mixtral-8x7b", 1.25, 64), ("mixtral-8x7b", 0.25, 12),
                  ("deepseek-v2-236b", 1.25, 64),
                  ("deepseek-v2-236b", 0.25, 12)]


@pytest.mark.parametrize("arch, factor, n", MOE_GRAD_CASES)
def test_moe_layer_gradients_match_jax(arch, factor, n):
    """``L = Σ out·r + aux`` and ``aux`` alone: their gradients in x and
    every MoE leaf against ``jax.grad`` of ``_apply_moe_local``, with
    pairs dropped and the dropped pairs' slot inside the buffer, where
    its cotangent goes to the one pair that won it."""
    base = jax_reduced(arch)
    jcfg = dataclasses.replace(base, compute_dtype="float32",
                               moe=dataclasses.replace(
                                   base.moe, capacity_factor=factor))
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(n)
    d = jcfg.d_model
    # crowded: the tokens share a direction, so the router sends most to
    # the same experts
    x = (rng.normal(size=(1, n, d)) * 0.8
         + rng.normal(size=(d,))).astype(np.float32)
    r = rng.normal(size=(1, n, d)).astype(np.float32)

    # the drops land in slot n_pairs + 1, inside the buffer
    m = jcfg.moe
    cap = jmoe._capacity(n, jcfg)
    xt = torch.from_numpy(x.reshape(n, d))
    gate, idx = tmoe.router_topk(xt @ tp["router"], m.top_k)
    _, (slot, keep, *_) = tmoe._dispatch(xt, gate, idx, cap, tcfg)
    n_pairs = n * m.top_k
    assert n_pairs + 1 < m.num_experts * cap
    assert int((~keep).sum()) > 0 and bool((slot == n_pairs + 1).any())

    def jloss(aux_only):
        def f(p, x):
            out, aux = jmoe._apply_moe_local(p, x, jcfg)
            return aux if aux_only else jnp.sum(out * r) + aux
        return f

    for aux_only in (False, True):
        wp, wx = jax.jit(jax.grad(jloss(aux_only), argnums=(0, 1)))(
            jp, jnp.asarray(x))
        ps = {k_: v_.clone().requires_grad_() if isinstance(v_, torch.Tensor)
              else v_ for k_, v_ in tp.items()}
        if "shared" in ps:
            ps["shared"] = {k_: v_.clone().requires_grad_()
                            for k_, v_ in tp["shared"].items()}
        tx = torch.from_numpy(x).requires_grad_()
        out, aux = tmoe.apply_moe(ps, tx, tcfg)
        loss = aux if aux_only else (out * torch.from_numpy(r)).sum() + aux
        flat = dict(flatten_with_path(ps))
        gs = torch.autograd.grad(loss, [tx] + list(flat.values()),
                                 allow_unused=True)
        assert _rel(wx, gs[0]) < TOL, ("x", aux_only, _rel(wx, gs[0]))
        want = _flat(wp)
        assert sorted(want) == sorted(flat)
        for path, g in zip(flat, gs[1:]):
            if aux_only and path != "['router']":
                # only the router's probabilities reach the aux term
                assert g is None or not g.any(), path
                assert not want[path].any(), path
                continue
            assert g is not None, path
            assert _rel(want[path], g) < TOL, (path, aux_only,
                                              _rel(want[path], g))
    if "shared" in tp:
        assert "['shared']['w_up']" in want


def test_router_topk_value_gradient_matches_lax_top_k_at_ties():
    """The gate's gradient goes through the top-k values only, to the
    experts chosen, ties to the lower expert id, as ``lax.top_k``'s."""
    logits = np.array([[0.0, 1.0, 1.0, 1.0], [2.0, 2.0, 0.0, 2.0],
                       [0.5, 0.5, 0.5, 0.5], [3.0, -1.0, 0.2, 1.5]],
                      np.float32)
    w = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32)
    want = jax.grad(lambda lg: jnp.sum(jmoe.router_topk(lg, 2)[0] * w))(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    gate, _ = tmoe.router_topk(tl, 2)
    (got,) = torch.autograd.grad((gate * torch.from_numpy(w)).sum(), tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _mla(jcfg):
    return dataclasses.replace(jcfg, mla=MLAConfig(**golden.DEEPSEEK_MLA))


# arch, overrides of the exact config, batch (B, T): mixtral's window of
# 32 under 48 tokens, DeepSeek at the published MLA widths (q/k 192 over
# v 128), gemma at head dim 256 over one KV head, nemotron at 192
MODEL_CASES = [("mixtral-8x7b", {}, (2, 48)),
               ("deepseek-v2-236b", "mla", (2, 24)),
               ("gemma-2b", dict(head_dim=256), (2, 24)),
               ("nemotron-4-340b", dict(head_dim=192), (2, 24))]


def _model_cfgs(exact_config, arch, over):
    jcfg = exact_config(arch) if over == "mla" else exact_config(arch,
                                                                 **over)
    if over == "mla":
        jcfg = _mla(jcfg)
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("arch, over, bt", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_model_loss_and_every_gradient_match_jax(arch, over, bt,
                                                 exact_config):
    jcfg, cfg = _model_cfgs(exact_config, arch, over)
    jmodel = jax_build(jcfg)
    flat = golden.seeded(jmodel.init(jax.random.key(4)), 4)
    jparams = jax.tree.map(jnp.asarray, flat)
    batch = next(jax_lm_iterator(jcfg, *bt, seed=4))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg, "cpu")
    params = _port_params(jparams, cfg)
    (loss, m), grads = gradlib.accumulate_grads(
        model.loss, params, {k: torch.as_tensor(v) for k, v in batch.items()},
        1, unread=model.unread_leaves())
    for key in ("loss", "ce", "aux"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            GRAD_TOL * abs(float(jm[key])) + 1e-7, key
    assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    want, got = _flat(jgrads), _flat(grads)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        assert np.abs(w).max() > 0, path
        assert _rel(w, got[path]) < GRAD_TOL, (path, _rel(w, got[path]))
    if arch == "deepseek-v2-236b":     # both stacks carry gradients
        assert any("dense_blocks" in p for p in want)
        assert any("['blocks']['moe']" in p for p in want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _step_setup(arch, state_dtype):
    """Reduced fp32 ``arch`` (DeepSeek at the published MLA widths) from
    seeded JAX parameters: the JAX and port configs, train configs and
    parameters.  AdamW's eps is 1e-6: at 1e-8 an element whose gradient
    sits at the two packages' summation noise (1e-6 of the largest) gets
    an update of either sign and up to the learning rate."""
    jcfg = dataclasses.replace(jax_reduced(arch), compute_dtype="float32")
    if arch == "deepseek-v2-236b":
        jcfg = _mla(jcfg)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    aw = dict(OPT["adamw"], state_dtype=state_dtype, eps=1e-6)
    jt = jprograms.TrainConfig(adamw=jadamw.AdamWConfig(**aw),
                               sched=jsched.ScheduleConfig(**OPT["sched"]))
    tt = programs.TrainConfig(adamw=adamw.AdamWConfig(**aw),
                              sched=schedule.ScheduleConfig(**OPT["sched"]))
    jparams = jax.tree.map(jnp.asarray, golden.seeded(
        jax_build(jcfg).init(jax.random.key(6)), 6))
    return jcfg, cfg, jt, tt, jparams


@pytest.mark.parametrize("arch, state_dtype", [
    ("mixtral-8x7b", "float32"), ("deepseek-v2-236b", "float32"),
    ("deepseek-v2-236b", "int8")])
def test_three_train_steps_match_jax(arch, state_dtype):
    """Losses, ce, aux and grad norms of 3 steps (the first at lr 0) at
    the default capacity factor (pairs drop).  With fp32 moments the
    final parameters match too.  With int8 moments a moment's rounding
    step turns the packages' summation noise into a different update of
    the entries whose moment lands on the other level: after 3 steps
    the port's own parameters differ from JAX's by more than 2e-4 in 9
    of 1 853 696 entries for DeepSeek (at most 6.1e-5 of a leaf), by at
    most 1.3e-3, under one step's move at the peak learning rate (3e-3).
    So the port's own step is held to that: at most 1e-3 of a leaf past
    2e-4, every entry within the peak learning rate.  Beside it the
    port's AdamW is driven by JAX's own gradients, and its parameters
    (within 2e-4) and int8 moments are held against JAX's: the payloads
    equal but where the two packages' ``log``/``exp`` land a value on
    the other side of a rounding step (in at most 1e-3 of the entries,
    by one level a step), the block scales within 1e-5 but in the 1% of
    blocks whose bounds such an entry moves."""
    jcfg, cfg, jt, tt, jparams = _step_setup(arch, state_dtype)
    jopt = jadamw.init_state(jparams, jt.adamw)
    params = _port_params(jparams, cfg)
    opt = adamw.init_state(params, tt.adamw)
    jstep = jax.jit(jprograms.build_train_step(jcfg, jt))
    step = programs.build_train_step(cfg, tt, "cpu")
    int8 = state_dtype == "int8"
    if int8:
        jgrad = jax.jit(jax.grad(lambda p, b: jax_build(jcfg).loss(p, b)[0]))
        oparams = _port_params(jparams, cfg)
        oopt = adamw.init_state(oparams, tt.adamw)
    data = jax_lm_iterator(jcfg, 2, 40, seed=6)
    for _ in range(3):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        if int8:
            grads = from_numpy_tree(jax.tree.map(np.asarray, jgrad(
                jparams, batch)), cfg, "cpu")
            scale = schedule.lr_multiplier(oopt["step"], tt.sched)
            with torch.no_grad():
                oparams, oopt, _ = adamw.apply_updates(oparams, grads, oopt,
                                                       tt.adamw, scale)
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        params, opt, m = step(params, opt, {k: torch.tensor(np.asarray(v))
                                            for k, v in batch.items()})
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= \
                STEP_TOL * abs(float(jm[key])), key
        assert float(m["aux"]) > 0
    want = _flat(jparams)
    got = _flat(oparams if int8 else params)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=STEP_TOL,
                                   err_msg=path)
    if int8:                          # the port's own int8 step
        own = _flat(params)
        for path, w in want.items():
            d = np.abs(own[path] - w)
            assert d.max() <= OPT["adamw"]["lr"] \
                and (d > STEP_TOL).mean() <= 1e-3, (path, float(d.max()))
        for mom in ("m", "v"):
            got = dict(flatten_with_path(oopt[mom]))
            for p, w in jax.tree_util.tree_flatten_with_path(jopt[mom])[0]:
                g = got[jax.tree_util.keystr(p)]
                if g.dtype == torch.int8:
                    diff = np.abs(g.numpy().astype(np.int32)
                                  - np.asarray(w).astype(np.int32))
                    assert diff.max() <= 3 and (diff > 0).mean() <= 1e-3, p
                else:         # a block's bounds move with such an entry
                    close = np.isclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-12)
                    assert close.mean() >= 0.99, p


def test_int8_update_in_chunks_equals_the_whole_leaf(monkeypatch):
    """AdamW with int8 moments steps a leaf ``_CHUNK`` elements at a time
    (whole quantization blocks): the parameters, payloads and scales are
    those of one pass over the whole leaf, bit for bit, over 3 steps,
    with a ragged last block, in bf16 and fp32 parameters."""
    cfg = adamw.AdamWConfig(lr=1e-2, state_dtype="int8", quant_block=16)
    gen = torch.Generator().manual_seed(0)

    def run(chunk):
        monkeypatch.setattr(adamw, "_CHUNK", chunk)
        params = {"w": torch.randn(7, 45, generator=gen.manual_seed(1))
                  .to(torch.bfloat16),
                  "b": torch.randn(301, generator=gen.manual_seed(2))}
        state = adamw.init_state(params, cfg)
        for i in range(3):
            grads = {k: torch.randn(p.shape, generator=gen.manual_seed(
                10 + i)).to(p.dtype) for k, p in params.items()}
            params, state, _ = adamw.apply_updates(params, grads, state,
                                                   cfg, 0.5 * i)
        return flatten_with_path({"p": params, "s": state})

    whole, chunked = run(1 << 30), run(48)
    assert [p for p, _ in whole] == [p for p, _ in chunked]
    for (path, a), (_, b) in zip(whole, chunked):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------

def test_trainer_trains_mixtral_and_restarts(tmp_path):
    """``Trainer`` on reduced mixtral at the CPU: 3 steps in one run, or
    2, a checkpoint, then 1 more from a fresh ``Trainer``: the same last
    loss and parameters; the metrics carry ``ce`` and ``aux``."""
    cfg = get_reduced_config("mixtral-8x7b")

    def trainer(d):
        return Trainer(cfg, "cpu", run_cfg=TrainerConfig(
            ckpt_dir=str(d), ckpt_every=0, log_every=1000))

    whole = trainer(tmp_path / "a").initialize(restore=False)
    hist = whole.fit(make_lm_iterator(cfg, 2, 40, seed=1), num_steps=3)
    part = trainer(tmp_path / "b").initialize(restore=False)
    part.fit(make_lm_iterator(cfg, 2, 40, seed=1), num_steps=2)
    again = trainer(tmp_path / "b").initialize(restore=True)
    assert again.step == 2
    data = make_lm_iterator(cfg, 2, 40, seed=1)
    for _ in range(2):
        next(data)
    m = again.train_step(next(data))
    assert all(np.isfinite(hist["loss"]))
    assert m["loss"] == hist["loss"][-1]
    assert m["aux"] > 0 and abs(m["loss"] - m["ce"] - m["aux"]) < 1e-5
    for a, b in zip(leaves(whole.params), leaves(again.params)):
        assert torch.equal(a, b)


def test_train_launcher_trains_deepseek_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    tr, hist = train.main(["--arch", "deepseek-v2-236b", "--reduced",
                           "--device", "cpu", "--steps", "2", "--batch",
                           "2", "--seq", "16", "--ckpt-dir",
                           str(tmp_path)])
    assert "final loss" in capsys.readouterr().out
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert tr.cfg.family == "moe" and ck.latest_step(str(tmp_path)) == 2


def test_train_launcher_restarts_deepseek_on_cpu(tmp_path):
    """``launch/train.py --arch deepseek-v2-236b --reduced``: 2 steps,
    then one more from their checkpoint (the stream replayed), against 3
    steps that did not stop: the same last loss, as ``chip_smoke.py``
    checks on the card."""
    from repro_torch.launch import train

    args = ["--arch", "deepseek-v2-236b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16"]
    _, whole = train.main(args + ["--steps", "3", "--ckpt-dir",
                                  str(tmp_path / "a")])
    train.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    again, rest = train.main(args + ["--steps", "1", "--ckpt-dir",
                                     str(tmp_path / "b")])
    assert again.step == 3 and np.isfinite(whole["loss"][-1])
    assert abs(rest["loss"][-1] - whole["loss"][-1]) <= \
        1e-6 * abs(whole["loss"][-1])


# ---------------------------------------------------------------------------
# the golden fixture's training runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored():
    with np.load(golden.PATH) as f:
        return {k: f[k] for k in f.files}


def test_golden_moe_train_runs_regenerate(stored):
    """The ``*_train_*`` runs rebuilt from JAX equal the committed file
    (within 1e-6), from the parameters it holds under ``params0_from``."""
    fresh = golden.moe_train()
    assert sorted(fresh) == sorted(k for k in stored if k.startswith(
        tuple(golden.MOE_TRAIN_RUNS)))
    for k, v in fresh.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


@pytest.mark.parametrize("pre", list(golden.MOE_TRAIN_RUNS))
def test_golden_moe_train_run_replays_on_cpu(pre, stored, tmp_path):
    """Each run replayed by ``Trainer`` from its step-0 state, fed the
    file alone: losses and grad norms within 2e-4 relative, final
    parameters within 2e-4."""
    g = {k[len(pre):]: v for k, v in stored.items() if k.startswith(pre)}
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    setup = json.loads(str(g["setup"]))
    src = str(g["params0_from"])

    def tree(items, prefix):
        return from_numpy_tree(unflatten({k[len(prefix):]: v
                                          for k, v in items.items()
                                          if k.startswith(prefix)}),
                               cfg, "cpu")
    ck.save(str(tmp_path), 0, {"params": tree(stored, src), "opt": {
        "step": torch.tensor(0, dtype=torch.int32),
        "m": tree(g, "opt0/m/"), "v": tree(g, "opt0/v/")}}, {"step": 0})
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    tr = Trainer(cfg, "cpu", tcfg, TrainerConfig(ckpt_dir=str(tmp_path),
                                                 ckpt_every=0))
    tr.initialize(restore=True)
    data = make_lm_iterator(cfg, setup["batch"], setup["seq"],
                            seed=setup["seed"])
    ms = [tr.train_step(next(data)) for _ in range(setup["steps"])]
    np.testing.assert_allclose([m["loss"] for m in ms], g["losses"],
                               rtol=STEP_TOL)
    np.testing.assert_allclose([m["grad_norm"] for m in ms],
                               g["grad_norms"], rtol=STEP_TOL)
    got = dict(flatten_with_path(tr.params))
    want = tree(g, "final/")
    for path, w in flatten_with_path(want):
        np.testing.assert_allclose(got[path].detach().numpy(), w.numpy(),
                                   rtol=0, atol=STEP_TOL, err_msg=path)
    shutil.rmtree(tmp_path, ignore_errors=True)

"""The port's MoE layer and sliding-window attention against the JAX
package, on the CPU: ``mixtral-8x7b`` reduced (4 experts of 128, top 2,
window 32) and in fp32.

- ``apply_moe`` against JAX ``_apply_moe_local`` at reduced mixtral's
  MoE and at DeepSeek's (shared experts included): with the default
  capacity factor 1.25 and inputs that crowd the experts, so that pairs
  drop (the same pairs in both, and the same rows in the dispatch
  buffer), and with no drops; outputs and the aux loss.
- The top-k's ties go to the lower expert id, as ``lax.top_k``.
- The ring fill: a write of more positions than the ring holds keeps the
  later ones, as JAX's sequential scatter does.
- ``Model.forward`` logits and aux, ``Model.loss``, and greedy
  ``ServingEngine`` streams byte-equal to the JAX engine's at the default
  capacity, with prompts longer than the window (the ring wraps in
  prefill and again in decode); the golden fixture's ``mixtral_*``
  entries, which ``chip_smoke.py`` replays on the card.
- ``launch/serve.py --arch mixtral-8x7b --reduced --device cpu``.
- ``num_params``/``active_params`` of mixtral and DeepSeek, that the
  port takes leading dense layers beside a window and a full-attention
  MoE (which pages) and refuses the moe family without a config, and
  that ``Trainer`` and ``launch/train.py`` take a
  moe arch (``tests/test_torch_moe_train.py`` holds MoE training against
  JAX).

Tolerances: 2e-4 relative for logits (``tests/test_decode_consistency.py
:42``), 2e-5 for fp32 MoE outputs and 3.5e-2 for bf16 relative to the
largest output (``tests/test_kernels.py:15``)."""
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
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

LOGIT_TOL = 2e-4
TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _mixtral(**over):
    """Reduced fp32 mixtral, the JAX and the port config."""
    jcfg = dataclasses.replace(jax_reduced("mixtral-8x7b", **over),
                               compute_dtype="float32")
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _models(seed=0, **over):
    """Reduced fp32 mixtral's JAX parameters (norm scales seeded away
    from one) and the port's, through the bridge."""
    jcfg, tcfg = _mixtral(**over)
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(seed)), seed)
    return (jcfg, jax.tree.map(jnp.asarray, flat), tcfg,
            from_numpy_tree(flat, tcfg, "cpu"))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

# (arch, dtype, crowded): ``crowded`` inputs share one direction, so the
# router sends most tokens to the same experts and pairs drop
MOE_CASES = [("mixtral-8x7b", "float32", True),
             ("mixtral-8x7b", "float32", False),
             ("mixtral-8x7b", "bfloat16", True),
             ("deepseek-v2-236b", "float32", True),
             ("deepseek-v2-236b", "float32", False)]


@pytest.mark.parametrize("arch, dtype, crowded", MOE_CASES,
                         ids=[f"{a}-{d}-{'drops' if c else 'nodrops'}"
                              for a, d, c in MOE_CASES])
def test_apply_moe_matches_jax_local(arch, dtype, crowded):
    jcfg = dataclasses.replace(jax_reduced(arch), compute_dtype=dtype)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jp = jmoe.init_moe(jax.random.key(1), jcfg)
    flat = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = from_numpy_tree(flat, tcfg, "cpu")
    assert tp["router"].dtype == torch.float32
    rng = np.random.default_rng(2)
    n, d = 64, jcfg.d_model
    x = rng.normal(size=(1, n, d))
    if crowded:
        x = x * 0.8 + rng.normal(size=(d,))
    x = x.astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want, want_aux = jmoe._apply_moe_local(jp, jnp.asarray(x, jdt), jcfg)
    got, got_aux = tmoe.apply_moe(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt and got.shape == (1, n, d)
    assert _rel(want, got) < TOL[dtype]
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * abs(
        float(want_aux))
    # the same pairs drop, and the dispatch buffers hold the same rows
    xt = jnp.asarray(x.reshape(n, d), jdt)
    gate, idx = jmoe.router_topk(xt.astype(jnp.float32) @ jp["router"],
                                 jcfg.moe.top_k)
    cap = jmoe._capacity(n, jcfg)
    jbuf, (_, jkeep, _, _) = jmoe._dispatch(xt, gate, idx, cap, jcfg)
    txt = torch.from_numpy(x.reshape(n, d)).to(tdt)
    tgate, tidx = tmoe.router_topk(txt.float() @ tp["router"],
                                   tcfg.moe.top_k)
    assert tidx.tolist() == np.asarray(idx).tolist()
    tbuf, (_, tkeep, *_) = tmoe._dispatch(txt, tgate, tidx, cap, tcfg)
    assert tkeep.tolist() == np.asarray(jkeep).tolist()
    assert (not bool(tkeep.all())) == crowded
    np.testing.assert_array_equal(tbuf.float().numpy(),
                                  np.asarray(jbuf, np.float32))


def test_router_topk_ties_go_to_the_lower_expert():
    logits = np.array([[0.0, 1.0, 1.0, 1.0], [2.0, 2.0, 0.0, 2.0],
                       [0.5, 0.5, 0.5, 0.5]], np.float32)
    jg, ji = jmoe.router_topk(jnp.asarray(logits), 2)
    tg, ti = tmoe.router_topk(torch.from_numpy(logits), 2)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2], [0, 1],
                                                      [0, 1]]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-7)


def test_apply_moe_refuses_a_multi_rank_group(monkeypatch):
    """Under rules over a mesh of more than one rank the MoE layer takes
    its sharded paths, which need the mesh's process group: a mesh that is
    only a shape (no devices, no group) is refused.  Outside a rules
    context it runs the local path, as JAX does, even in a process group
    of two ranks."""
    from repro_torch.distributed import sharding as tsh

    _, tcfg = _mixtral()
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    x = torch.zeros(1, 3, tcfg.d_model)

    class ShapeOnly:
        shape = {"data": 1, "model": 2}

    with tsh.use_rules(ShapeOnly(), tsh.single_pod_rules()):
        with pytest.raises(ValueError, match="process group"):
            tmoe.apply_moe(tp, x, tcfg)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    out, _ = tmoe.apply_moe(tp, x, tcfg)
    assert torch.equal(out, tmoe._apply_moe_local(tp, x, tcfg)[0])


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

def test_ring_fill_keeps_the_later_positions():
    """S 4096, T 5000, rows 64 wide: every one of the 904 wrapped slots
    holds its later position, as JAX's scatter leaves it.  The repeated
    slots of one index assignment raced across the CPU's threads (279 or
    346 of the 904 stale at 8 threads), so the fill runs on 8 threads
    here, five times over."""
    S, T, W = 4096, 5000, 64
    pos = np.arange(T)[None]
    kv = np.broadcast_to(pos[..., None, None], (1, T, 1, W)).astype(
        np.float32)
    want = jattn._fill_cache({"k": jnp.zeros((1, S, 1, W)),
                              "v": jnp.zeros((1, S, 1, W))},
                             jnp.asarray(kv), jnp.asarray(kv),
                             jnp.asarray(pos), None)
    want = np.asarray(want["k"])
    assert want[0, :904, 0, 0].tolist() == list(range(4096, 5000))
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(8)
        for _ in range(5):
            cache = {"k": torch.zeros(1, S, 1, W),
                     "v": torch.zeros(1, S, 1, W)}
            tattn._fill_cache(cache, torch.from_numpy(kv),
                              torch.from_numpy(kv), torch.from_numpy(pos))
            stale = int((cache["k"][0, :, 0, 0].numpy()
                         != want[0, :, 0, 0]).sum())
            assert stale == 0, f"{stale} of 904 wrapped slots are stale"
            np.testing.assert_array_equal(cache["v"].numpy(), want)
    finally:
        torch.set_num_threads(threads)


def test_ring_cache_capacity_and_shapes():
    for max_seq in (16, 32, 128):
        jcfg, tcfg = _mixtral()
        assert tattn.cache_capacity(tcfg, max_seq) == \
            jattn.cache_capacity(jcfg, max_seq) == min(32, max_seq)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax_build(jcfg).init_caches(2, max_seq,
                                                        jnp.float32))
        got = Model(tcfg, "cpu").init_caches(2, max_seq, torch.float32)
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                       .removeprefix("torch.")),
                            got) == want
    full = get_config("mixtral-8x7b")
    assert tattn.cache_capacity(full, 8192) == 4096


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_mixtral_logits_and_aux_match_jax():
    """80 tokens over a window of 32 at the default capacity."""
    jcfg, jp, tcfg, tp = _models()
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               size=(2, 80))
    want, want_aux = jax_build(jcfg).forward(
        jp, {"tokens": jnp.asarray(tokens)})
    model = Model(tcfg, "cpu")
    with torch.no_grad():
        got, aux = model.forward_with_aux(
            tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 80, jcfg.vocab_size)
    assert _rel(want, got) < LOGIT_TOL
    assert abs(float(aux) - float(want_aux)) < LOGIT_TOL * float(want_aux)
    assert float(aux) > 0
    # the tree the port makes itself has the JAX leaves and shapes
    own = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), own) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert own["stack"]["blocks"]["moe"]["router"].dtype == torch.float32


def test_mixtral_loss_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=3)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 48))
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 48))
    labels[:, :4] = -1
    want, wm = jax_build(jcfg).loss(jp, {"tokens": jnp.asarray(tokens),
                                         "labels": jnp.asarray(labels)})
    got, gm = Model(tcfg, "cpu").loss(tp, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    for key in ("loss", "ce", "aux"):
        assert abs(float(gm[key]) - float(wm[key])) <= \
            LOGIT_TOL * abs(float(wm[key])), key
    assert float(gm["tokens"]) == float(wm["tokens"]) == 88
    assert abs(float(got) - float(want)) <= LOGIT_TOL * abs(float(want))


def _prompts(n=5, lo=40, hi=91, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(m))
            for m in rng.integers(lo, hi, size=n)]


def _serve(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    eng.run_until_drained()
    return [list(r.generated) for r in sorted(eng.completed.values(),
                                              key=lambda r: r.rid)]


def test_mixtral_engine_streams_equal_jax_engine():
    """Prompts of 40-90 tokens over a ring of 32 on 2 slots, at the
    default capacity: each prompt prefills once at its exact length, the
    ring wraps in prefill and again in decode, and a decode tick routes
    both slots' rows.  The JAX engine is warmed first, so its slot tree is
    in fp32 before the first insert."""
    jcfg, jp, tcfg, tp = _models(seed=2)
    kw = dict(max_slots=2, max_seq=128, prefill_chunk=16)
    je = JaxEngine(jcfg, params=jp, **kw).warmup()
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw).warmup()
    assert not te.paged and te._stateful
    assert te.kv.caches["attn"]["k"].shape[2] == 32
    prompts = _prompts()
    want, got = _serve(je, prompts, 20), _serve(te, prompts, 20)
    assert got == want and all(len(g) == 20 for g in got)
    assert te.stats()["prefill_chunks"] == len(prompts)


def test_mixtral_warmup_runs_no_prefill():
    """A sliding-window arch prefills at each prompt's exact length, so
    warmup runs the decode step only (a max_seq prompt would be the
    warmup's)."""
    _, tcfg = _mixtral()
    eng = ServingEngine(tcfg, max_slots=2, max_seq=128, device="cpu")
    calls = []
    eng._prefill = lambda *a: calls.append(a)
    eng.warmup()
    assert calls == [] and eng._warm


def test_golden_mixtral_replays_on_the_cpu():
    """The fixture's ``mixtral_*`` entries: the port, fed the file alone,
    gives the JAX engine's streams and ``Model.forward``'s last-position
    logits; ``chip_smoke.py`` replays them on the card."""
    pre = "mixtral_"
    with np.load(golden.PATH) as f:
        g = {k[len(pre):]: f[k] for k in f.files if k.startswith(pre)}
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    assert cfg.sliding_window == 32 and cfg.compute_dtype == "float32"
    assert cfg.moe.capacity_factor == 1.25
    params = from_numpy_tree(unflatten(
        {k[len("params/"):]: v for k, v in g.items()
         if k.startswith("params/")}), cfg, "cpu")
    eng = ServingEngine(cfg, params=params, device="cpu",
                        **json.loads(str(g["engine"])))
    prompts = [p[:n] for p, n in zip(g["prompts"], g["prompt_lens"])]
    assert min(len(p) for p in prompts) > cfg.sliding_window
    assert _serve(eng, prompts, int(g["max_new"])) == g["streams"].tolist()
    with torch.no_grad():
        for p, want in zip(prompts, g["last_logits"]):
            lg = eng.model.forward(params, {"tokens": torch.from_numpy(
                p[None].astype(np.int64))})[0, -1]
            assert _rel(want, lg) < LOGIT_TOL


def test_serve_launcher_runs_reduced_mixtral(capsys):
    from repro_torch.launch import serve

    system = serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                         "cpu", "--requests", "3", "--max-new", "6"])
    (dep,) = system.instances("llm-serving")
    eng = dep.executor.engine
    assert not eng.paged and len(eng.completed) == 3 and not eng.failed
    assert all(len(r.generated) == 6 for r in eng.completed.values())
    assert "dense slots" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# configs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_param_counts_match_jax(arch):
    for jcfg in (jax_config(arch), jax_reduced(arch)):
        tcfg = ModelConfig.from_dict(jcfg.to_dict())
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.active_params() == jcfg.active_params()
    if arch == "mixtral-8x7b":
        full = get_config(arch)
        assert full.to_dict() == jax_config(arch).to_dict()
        assert full.num_params() == 46_702_792_704
        assert dataclasses.replace(full, num_layers=8).num_params() == \
            11_872_309_248
        assert get_reduced_config(arch).to_dict() == \
            jax_reduced(arch).to_dict()
        check_ported(full)


def test_unported_moe_variants_raise():
    """DeepSeek (MLA with its leading dense layer) is ported
    (``tests/test_torch_mla.py``), and so are its leading dense layers
    beside sliding-window attention and a full-attention MoE, which pages
    (``tests/test_torch_moe_paged.py``); the moe family without a ``moe``
    config is refused with JAX's failure.  The trainer and the train
    launcher take the moe family: one CPU step each on reduced mixtral."""
    from repro_torch.launch import train
    from repro_torch.train.trainer import Trainer, TrainerConfig

    ds = ModelConfig.from_dict(jax_config("deepseek-v2-236b").to_dict())
    check_ported(ds)
    assert get_config("deepseek-v2-236b") == ds
    mix = get_config("mixtral-8x7b")
    no_mla = dataclasses.replace(ds, attn_type="swa", sliding_window=64)
    check_ported(no_mla)
    full = dataclasses.replace(mix, attn_type="full", sliding_window=0)
    check_ported(full)
    with pytest.raises(NotImplementedError, match="moe=None"):
        check_ported(dataclasses.replace(mix, moe=None))
    import tempfile

    from repro_torch.data.tokens import make_lm_iterator

    cfg = get_reduced_config("mixtral-8x7b")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, "cpu", run_cfg=TrainerConfig(ckpt_dir=d))
        m = tr.initialize(restore=False).train_step(
            next(make_lm_iterator(cfg, 2, 16)))
        assert np.isfinite(m["loss"]) and m["aux"] > 0 and tr.step == 1
        _, hist = train.main(["--arch", "mixtral-8x7b", "--reduced",
                              "--device", "cpu", "--steps", "1",
                              "--batch", "2", "--seq", "16",
                              "--ckpt-dir", d + "/launch"])
        assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    with pytest.raises(ValueError, match="speculative decoding needs"):
        ServingEngine(get_reduced_config("mixtral-8x7b"), device="cpu",
                      draft_cfg=get_reduced_config("mixtral-8x7b"))
    assert ServingEngine(dataclasses.replace(
        get_reduced_config("mixtral-8x7b"), attn_type="full",
        sliding_window=0), device="cpu").paged

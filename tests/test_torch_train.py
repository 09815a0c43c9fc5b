"""The port's training path against the JAX package on the CPU: the loss
and every gradient of ``Model.loss``, AdamW (fp32 and int8 moments), the
LR schedule, microbatch accumulation, gradient compression, the data
stream, checkpointing (including checkpoints the JAX trainer wrote), the
``Trainer`` over 10 steps from a JAX checkpoint, and the launcher.

Inputs come from numpy seeds or from JAX-made parameters carried over
with ``from_numpy_tree`` or a checkpoint.  Bounds: 2e-4 relative per
gradient leaf under the fp32 ``exact_config`` (the model bound of
``tests/test_decode_consistency.py:42``); 1e-6 for one optimizer step;
1e-4 for losses and parameters after 10 training steps."""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jck
from repro.configs import get_reduced_config as jreduced
from repro.data.tokens import make_lm_iterator as jax_lm_iterator
from repro.launch import programs as jprograms
from repro.launch.mesh import make_test_mesh
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw, grad as jgrad, schedule as jsched
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.data.tokens import make_lm_iterator
from repro_torch.launch import programs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.optim import adamw, grad as gradlib, schedule
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, leaves, tree_map

import torch_port_golden as golden

torch.set_num_threads(1)


def _rel(want, got):
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jcfg) -> ModelConfig:
    return ModelConfig.from_dict(jcfg.to_dict())


def _flat(tree):
    """``{keystr: numpy}`` of a JAX or a torch tree."""
    if isinstance(jax.tree.leaves(tree)[0], jax.Array):
        return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {p: x.detach().float().numpy().copy()
            for p, x in flatten_with_path(tree)}


# ---------------------------------------------------------------------------
# Model.loss
# ---------------------------------------------------------------------------

def _loss_setup(exact_config):
    jcfg = exact_config("tinyllama-1.1b", d_model=64, head_dim=16, d_ff=128,
                        num_kv_heads=2)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, -3:] = -1
    (jloss, jm), jgrads = jax.value_and_grad(jax_build(jcfg).loss,
                                             has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    cfg = _port(jcfg)
    params = from_numpy_tree(_np_tree(jparams), cfg, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss, m = Model(cfg, "cpu").loss(params, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, leaves(params))
    return (jloss, jm, jgrads), (loss, m, dict(zip(
        [p for p, _ in flatten_with_path(params)], grads)))


def test_model_loss_and_every_gradient_match_jax(exact_config):
    (jloss, jm, jgrads), (loss, m, grads) = _loss_setup(exact_config)
    assert abs(float(loss.detach()) - float(jloss)) <= 2e-4 * abs(float(jloss))
    for k in ("loss", "ce", "aux", "tokens"):
        assert abs(float(m[k].detach()) - float(jm[k])) <= 2e-4 * max(
            abs(float(jm[k])), 1.0), k
    assert float(m["tokens"]) == 41.0
    want = _flat(jgrads)
    assert sorted(want) == sorted(grads)
    for path, w in want.items():
        assert _rel(w, grads[path].numpy()) < 2e-4, path


def test_loss_gradients_reach_the_attention_projections(exact_config):
    """The train-mode forward goes through the autograd function of flash
    attention, so w_q, w_k and w_v get JAX's gradients (on the card the
    CUDA forward kernel used to cut the graph there)."""
    (_, _, jgrads), (_, _, grads) = _loss_setup(exact_config)
    want = _flat(jgrads)
    for name in ("w_q", "w_k", "w_v"):
        path = f"['stack']['blocks']['attn']['{name}']"
        assert np.abs(grads[path].numpy()).max() > 0
        assert _rel(want[path], grads[path].numpy()) < 2e-4


# ---------------------------------------------------------------------------
# optimizer, schedule, gradient utilities
# ---------------------------------------------------------------------------

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "nested": {"m": (4, 4, 4)},
              "norm": {"scale": (2, 16)}}        # a stacked [L, d] norm

    def make(s):
        return {k: make(v) for k, v in s.items()} if isinstance(s, dict) \
            else rng.standard_normal(s).astype(np.float32)
    return make(shapes)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_apply_updates_matches_jax(state_dtype):
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip_norm=1.0,
               state_dtype=state_dtype, quant_block=64)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp, tp = _both(_opt_trees(0))
    js, ts = jadamw.init_state(jp, jcfg), adamw.init_state(tp, tcfg)
    for i in range(3):
        jg, tg = _both(jax.tree.map(lambda a: a * (i + 1),
                                    _opt_trees(10 + i)))
        scale = [0.0, 0.5, 1.0][i]
        jp, js, jm = jadamw.apply_updates(jp, jg, js, jcfg, scale)
        tp, ts, tm = adamw.apply_updates(tp, tg, ts, tcfg, scale)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for path, w in _flat(jp).items():           # relative to each leaf's max
        assert _rel(w, _flat(tp)[path]) < 1e-6, path
    if state_dtype == "float32":
        for name in ("m", "v"):
            want, got = _flat(js[name]), _flat(ts[name])
            for path, w in want.items():
                assert _rel(w, got[path]) < 1e-6, (name, path)
        return
    for name in ("m", "v"):          # same integers, scales within 1e-6
        want = jax.tree_util.tree_flatten_with_path(js[name])[0]
        got = dict(flatten_with_path(ts[name]))
        for p, w in want:
            g = got[jax.tree_util.keystr(p)]
            if g.dtype == torch.int8:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-12)


def test_weight_decay_only_on_matrices_including_stacked_norms():
    cfg = dict(lr=1e-2, weight_decay=0.5, grad_clip_norm=0.0)
    jp, tp = _both(_opt_trees(1))
    zeros = jax.tree.map(np.zeros_like, _opt_trees(1))
    jz, tz = _both(zeros)
    before = _flat(tp)
    jp2, _, _ = jadamw.apply_updates(jp, jz, jadamw.init_state(
        jp, jadamw.AdamWConfig(**cfg)), jadamw.AdamWConfig(**cfg))
    tp2, _, _ = adamw.apply_updates(tp, tz, adamw.init_state(
        tp, adamw.AdamWConfig(**cfg)), adamw.AdamWConfig(**cfg))
    after, want = _flat(tp2), _flat(jp2)
    np.testing.assert_array_equal(after["['b']"], before["['b']"])
    for path in ("['w']", "['nested']['m']", "['norm']['scale']"):
        assert np.all(np.abs(after[path]) < np.abs(before[path]))
        np.testing.assert_allclose(after[path], want[path], rtol=1e-6)


def test_grad_clipping():
    g = {"w": torch.full((100,), 10.0)}
    cfg = adamw.AdamWConfig(grad_clip_norm=1.0)
    assert float(adamw.global_norm(g)) == pytest.approx(100.0, rel=1e-6)
    p = {"w": torch.zeros(100)}
    _, state, metrics = adamw.apply_updates(p, g, adamw.init_state(p, cfg),
                                            cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0, rel=1e-6)
    # the first moment holds (1 - b1) x the clipped gradient (norm 1)
    np.testing.assert_allclose(state["m"]["w"].numpy(),
                               np.full(100, 0.1 * 0.1, np.float32),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_multiplier_matches_jax(kind):
    jc = jsched.ScheduleConfig(warmup_steps=10, decay_steps=100, kind=kind)
    tc = schedule.ScheduleConfig(warmup_steps=10, decay_steps=100, kind=kind)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(schedule.lr_multiplier(torch.tensor(s, dtype=torch.int32),
                                            tc)) == pytest.approx(
            float(jsched.lr_multiplier(s, jc)), rel=1e-6, abs=1e-7)


def test_accumulate_grads_four_microbatches_equal_one_batch(exact_config):
    cfg = _port(exact_config("tinyllama-1.1b", d_model=64, head_dim=16,
                             d_ff=128))
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              size=(8, 16)))
             for k in ("tokens", "labels")}
    (l1, m1), g1 = gradlib.accumulate_grads(model.loss, params, batch, 1)
    (l4, m4), g4 = gradlib.accumulate_grads(model.loss, params, batch, 4)
    assert float(l4) == pytest.approx(float(l1), rel=1e-5)
    assert float(m4["tokens"]) == float(m1["tokens"]) / 4   # mean per micro
    for (path, a), b in zip(flatten_with_path(g1), leaves(g4)):
        assert b.dtype == torch.float32
        assert _rel(a.numpy(), b.numpy()) < 1e-5, path


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_accumulate_grads_raises_when_the_graph_is_cut(exact_config,
                                                       monkeypatch,
                                                       num_microbatches):
    """An attention output cut from the graph leaves w_q, w_k, w_v and
    the norm before them without a gradient: that is an error naming
    them, never zeros."""
    from repro_torch.kernels import ops

    cfg = _port(exact_config("tinyllama-1.1b", d_model=64, head_dim=16,
                             d_ff=128))
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    attention = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: attention(*a, **kw).detach())
    batch = {k: torch.zeros((4, 8), dtype=torch.int64)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="no gradient") as err:
        gradlib.accumulate_grads(model.loss, params, batch, num_microbatches)
    for name in ("['attn']['w_q']", "['attn']['w_k']", "['attn']['w_v']",
                 "['norm1']['scale']"):
        assert name in str(err.value)
    assert "['w_o']" not in str(err.value)


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_decompress_matches_jax(with_residual):
    jg, tg = _both(_opt_trees(3))
    jr = tr = None
    if with_residual:
        jr, tr = _both(jax.tree.map(lambda a: a * 0.01, _opt_trees(4)))
    jd, jres = jgrad.compress_decompress(jg, block=64, residual=jr)
    td, tres = gradlib.compress_decompress(tg, block=64, residual=tr)
    for want, got in ((jd, td), (jres, tres)):
        for path, w in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[path], w, rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host", [0, 1])
def test_lm_iterator_matches_jax(host):
    jcfg = jreduced("tinyllama-1.1b")
    a = jax_lm_iterator(jcfg, 4, 16, seed=7, host_index=host, host_count=2)
    b = make_lm_iterator(_port(jcfg), 4, 16, seed=7, host_index=host,
                         host_count=2)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# checkpointing (the five behaviours of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _ck_tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "emb": torch.ones((5, 2), dtype=torch.bfloat16) * 1.5},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": [torch.zeros(3), torch.full((2, 2), -2.0)]},
    }


def test_checkpoint_roundtrip_preserves_dtypes_and_values(tmp_path):
    tree = _ck_tree()
    ck.save(str(tmp_path), 3, tree, extra_meta={"step": 3})
    got, extra = ck.restore(str(tmp_path))
    assert extra["step"] == 3
    assert isinstance(got["opt"]["m"], list)
    for (pw, w), (pg, g) in zip(flatten_with_path(tree),
                                flatten_with_path(got)):
        assert pw == pg and w.dtype == g.dtype and w.shape == g.shape
        assert torch.equal(w, g)


def test_checkpoint_uncommitted_ignored(tmp_path):
    ck.save(str(tmp_path), 1, _ck_tree())
    ck.save(str(tmp_path), 2, _ck_tree())
    os.remove(str(tmp_path / "step_000000002.COMMIT"))   # a crashed writer
    assert ck.latest_step(str(tmp_path)) == 1
    got, _ = ck.restore(str(tmp_path))
    assert torch.equal(got["params"]["w"], _ck_tree()["params"]["w"])


def test_async_checkpointer_and_gc(tmp_path):
    acp = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        acp.save(s, {"x": torch.full((4,), float(s))}, {"step": s})
    acp.wait()
    acp.gc()
    assert ck.committed_steps(str(tmp_path)) == [3, 4]
    got, extra = ck.restore(str(tmp_path))
    assert extra["step"] == 4
    assert torch.equal(got["x"], torch.full((4,), 4.0))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), target_tree={"b": {"c": 1}})


def test_checkpoint_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "nope"))


def test_port_restores_a_jax_checkpoint(tmp_path):
    """Parameters (one bf16 leaf among them) and fp32 AdamW state written
    by the JAX ``AsyncCheckpointer`` come back as equal torch tensors.
    (The JAX checkpointer cannot write int8 moments: its treedef proto
    refuses the ``QuantMoment`` node.)"""
    cfg = jadamw.AdamWConfig(quant_block=64)
    params = jax.tree.map(jnp.asarray, _opt_trees(5))
    params["half"] = jnp.linspace(-2, 2, 10, dtype=jnp.bfloat16)
    grads = jax.tree.map(jnp.ones_like, params)
    _, state, _ = jadamw.apply_updates(params, grads,
                                       jadamw.init_state(params, cfg), cfg)
    acp = jck.AsyncCheckpointer(str(tmp_path))
    acp.save(1, {"params": params, "opt": state}, extra_meta={"step": 1})
    acp.wait()
    got, extra = ck.restore(str(tmp_path))
    assert extra == {"step": 1}
    assert got["params"]["half"].dtype == torch.bfloat16
    want = jax.tree_util.tree_flatten_with_path(
        {"params": params, "opt": state})[0]
    flat = dict(flatten_with_path(got))
    assert sorted(flat) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for p, w in want:
        g = flat[jax.tree_util.keystr(p)]
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))


def test_int8_moments_roundtrip_as_quantmoments(tmp_path):
    """int8 AdamW state comes back from its paths (``['m']['w'].q``) as
    ``QuantMoment``s with equal integers and scales."""
    _, tp = _both(_opt_trees(6))
    cfg = adamw.AdamWConfig(state_dtype="int8", quant_block=64)
    _, state, _ = adamw.apply_updates(tp, tree_map(torch.ones_like, tp),
                                      adamw.init_state(tp, cfg), cfg)
    ck.save(str(tmp_path), 1, {"opt": state})
    got, _ = ck.restore(str(tmp_path))
    qm = got["opt"]["m"]["nested"]["m"]
    assert isinstance(qm, adamw.QuantMoment) and qm.q.dtype == torch.int8
    for (pw, w), (pg, g) in zip(flatten_with_path(state),
                                flatten_with_path(got["opt"])):
        assert pw == pg and torch.equal(w, g)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _train_cfg(head_dim=16):
    """tests/test_train_integration.py:17's model and optimizer, fp32."""
    jcfg = dataclasses.replace(
        jreduced("tinyllama-1.1b", num_layers=2, d_model=64,
                 head_dim=head_dim, d_ff=128, vocab_size=128),
        compute_dtype="float32")
    opt = dict(adamw=dict(lr=3e-3, grad_clip_norm=1.0),
               sched=dict(warmup_steps=5, decay_steps=200))
    jt = jprograms.TrainConfig(
        adamw=jadamw.AdamWConfig(**opt["adamw"]),
        sched=jsched.ScheduleConfig(**opt["sched"]))
    tt = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**opt["adamw"]),
        sched=schedule.ScheduleConfig(**opt["sched"]))
    return jcfg, jt, tt


def _port_trainer(path, tt, cfg, ckpt_every=50):
    return Trainer(cfg, "cpu", tt, TrainerConfig(
        ckpt_dir=str(path), ckpt_every=ckpt_every, log_every=1000))


def test_trainer_follows_the_jax_trainer_from_its_checkpoint(tmp_path):
    jcfg, jt, tt = _train_cfg()
    jtr = JTrainer(jcfg, make_test_mesh(1, 1), jt, JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), log_every=1000))
    jtr.initialize(restore=False)
    jtr.maybe_checkpoint(force=True)                # step 0
    jtr.checkpointer.wait()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ttr = _port_trainer(tmp_path / "port", tt, _port(jcfg))
    ttr.initialize(restore=True)
    assert ttr.step == 0
    jh = jtr.fit(jax_lm_iterator(jcfg, 8, 32, seed=3), num_steps=10)
    th = ttr.fit(make_lm_iterator(_port(jcfg), 8, 32, seed=3), num_steps=10)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert th["loss"][-1] < th["loss"][0]
    want, got = _flat(jtr.params), _flat(ttr.params)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4)


def test_checkpoint_restart_resumes_identically(tmp_path):
    jcfg, _, tt = _train_cfg()
    cfg = _port(jcfg)
    ta = _port_trainer(tmp_path / "a", tt, cfg, ckpt_every=5)
    ta.initialize(restore=False)
    ta.fit(make_lm_iterator(cfg, 8, 32, seed=3), num_steps=10)

    tb = _port_trainer(tmp_path / "b", tt, cfg, ckpt_every=5)
    tb.initialize(restore=False)
    tb.fit(make_lm_iterator(cfg, 8, 32, seed=3), num_steps=5)
    assert tb.step == 5
    del tb
    tc = _port_trainer(tmp_path / "b", tt, cfg, ckpt_every=5)
    tc.initialize(restore=True)                  # restores step 5
    assert tc.step == 5 and int(tc.opt_state["step"]) == 5
    data = make_lm_iterator(cfg, 8, 32, seed=3)
    for _ in range(5):                           # skip consumed batches
        next(data)
    tc.fit(data, num_steps=5)
    for a, c in zip(leaves(ta.params), leaves(tc.params)):
        np.testing.assert_allclose(c.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_trainer_records_straggler_metrics(tmp_path):
    jcfg, _, tt = _train_cfg()
    t = _port_trainer(tmp_path, tt, _port(jcfg))
    t.initialize(restore=False)
    m = t.train_step(next(make_lm_iterator(_port(jcfg), 8, 32)))
    for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr",
              "step_time_s", "straggler"):
        assert k in m and np.isfinite(m[k]), k
    assert m["lr"] == 0.0 and m["straggler"] == 0.0      # step 0: lr 0


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    train.main(["--reduced", "--steps", "3", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    assert "final loss" in capsys.readouterr().out
    assert ck.latest_step(str(tmp_path)) == 3
    for flags in (["--mesh", "single"], ["--mesh", "multi"],
                  ["--distributed"]):
        with pytest.raises(NotImplementedError, match="item 13"):
            train.main(["--reduced", "--device", "cpu", *flags])


def test_golden_training_run_replays_on_cpu(tmp_path):
    """The fixture's JAX training run (fp32) reproduced by the port on the
    CPU from the stored step-0 state: losses and grad norms within 1e-4
    relative, final parameters within 1e-4.  ``chip_smoke.py`` replays
    it on the card through the kernels."""
    with np.load(golden.PATH) as f:
        g = {k: f[k] for k in f.files}
    setup = json.loads(str(g["train_setup"]))
    cfg = ModelConfig.from_dict(json.loads(str(g["train_config"])))

    def tree(prefix):
        return unflatten({k[len(prefix):]: v for k, v in g.items()
                          if k.startswith(prefix)})

    params = from_numpy_tree(tree("train_params0/"), cfg, "cpu")
    opt = {"step": torch.tensor(0, dtype=torch.int32),
           "m": from_numpy_tree(tree("train_opt0/m/"), cfg, "cpu"),
           "v": from_numpy_tree(tree("train_opt0/v/"), cfg, "cpu")}
    ck.save(str(tmp_path), 0, {"params": params, "opt": opt}, {"step": 0})
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    t = _port_trainer(tmp_path, tcfg, cfg)
    t.initialize(restore=True)
    data = make_lm_iterator(cfg, setup["batch"], setup["seq"],
                            seed=setup["seed"])
    ms = [t.train_step(next(data)) for _ in range(setup["steps"])]
    np.testing.assert_allclose([m["loss"] for m in ms], g["train_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in ms],
                               g["train_grad_norms"], rtol=1e-4)
    want = tree("train_final/")
    for path, w in flatten_with_path(want):
        got = dict(flatten_with_path(t.params))[path]
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=0,
                                   atol=1e-4)

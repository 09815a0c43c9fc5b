"""Encoder training in the port against the JAX package, on the CPU, on the
same inputs made from numpy seeds:

- LayerNorm's backward (``layers._LayerNorm``): ``dx``, ``dscale`` and
  ``dbias`` against ``jax.vjp`` of the JAX custom VJP ``_layernorm_cv``, in
  fp32 and bf16;
- reduced ``edge-cv-heavy`` and ``hubert-xlarge`` (2 layers, d 128, head
  dims 48 and 80 by override) in fp32: ``Model.loss`` and every gradient
  leaf, the unread embedding's zero and ``mask_embed``'s among them;
- 3 steps of ``build_train_step`` against JAX ``programs.build_train_step``
  (losses, grad norms, final parameters: the embedding decayed as JAX
  decays it);
- the train launcher's encoder branch at ``--device cpu``, and a restart
  from its checkpoint that replays the batch stream;
- an encoder checkpoint written by the JAX trainer, restored by the
  port's ``Trainer``, whose next step's loss is JAX's;
- the golden fixture's ``encoder_train_*`` runs (5 JAX steps at head dims
  48 and 80) replayed by the port's ``Trainer`` from their step-0 state;
- the two trainer faults of ROADMAP Queue C (a batch's floating and
  boolean leaves cast to int64; the unread embedding refused by
  ``accumulate_grads``), and that a leaf cut from the graph still raises.

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) relative to the largest value
for the norm; 2e-4 relative per gradient leaf and for the loss (the two
packages sum in other orders over 2 layers); 1e-4 for losses, grad norms
and parameters after 3 steps.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import make_encoder_iterator as jax_encoder_iter
from repro.configs import get_reduced_config as jax_reduced
from repro.launch import programs as jprograms
from repro.launch.mesh import make_test_mesh
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw, schedule as jsched
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.data.tokens import make_encoder_iterator
from repro_torch.launch import programs
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree, unflatten
from repro_torch.optim import adamw, grad as gradlib, schedule
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, leaves

import torch_port_golden as golden

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = 2e-4
STEP_TOL = 1e-4
# each encoder at one of the encoders' new head dims (the two reduced
# configs share their shapes, so both widths and both archs are covered)
ARCH_HD = [("edge-cv-heavy", 48), ("hubert-xlarge", 80)]
EMBED = "['embed']['embedding']"
OPT = dict(adamw=dict(lr=3e-3, grad_clip_norm=1.0),
           sched=dict(warmup_steps=2, decay_steps=200))


def _rel(want, got) -> float:
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6))


def _cfgs(arch, hd):
    jcfg = dataclasses.replace(jax_reduced(arch, head_dim=hd),
                               compute_dtype="float32")
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


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


def _tcfgs():
    jt = jprograms.TrainConfig(adamw=jadamw.AdamWConfig(**OPT["adamw"]),
                               sched=jsched.ScheduleConfig(**OPT["sched"]))
    tt = programs.TrainConfig(adamw=adamw.AdamWConfig(**OPT["adamw"]),
                              sched=schedule.ScheduleConfig(**OPT["sched"]))
    return jt, tt


# ---------------------------------------------------------------------------
# LayerNorm's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 128), (2, 1280), (5, 100)])
def test_layer_norm_backward_matches_jax_custom_vjp(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    y, vjp = jax.vjp(lambda a, s, b: jlayers._layernorm_cv(a, s, b, 1e-5),
                     jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = vjp(jnp.asarray(g, jdt))
    tx = torch.as_tensor(x).to(tdt).requires_grad_()
    ts = torch.as_tensor(scale).requires_grad_()
    tb = torch.as_tensor(bias).requires_grad_()
    out = tlayers.layer_norm(tx, ts, tb, 1e-5)
    got = torch.autograd.grad(out, (tx, ts, tb), torch.as_tensor(g).to(tdt))
    assert _rel(np.asarray(y, np.float32), out.detach().float()) < TOL[dtype]
    for name, w, x_ in zip(("dx", "dscale", "dbias"), want, got):
        assert x_.dtype == (tdt if name == "dx" else torch.float32), name
        assert _rel(np.asarray(w, np.float32), x_.float()) < TOL[dtype], \
            (name, _rel(np.asarray(w, np.float32), x_.float()))


def test_layer_norm_builds_no_graph_without_grad():
    """Serving (no input needs a gradient) gets no graph and the same
    numbers as a training forward."""
    x = torch.randn(4, 96)
    s, b = torch.randn(96), torch.randn(96)
    y = tlayers.layer_norm(x, s, b, 1e-5)
    assert y.grad_fn is None
    y_train = tlayers.layer_norm(x, s.clone().requires_grad_(), b, 1e-5)
    assert y_train.grad_fn is not None
    assert torch.equal(y, y_train.detach())


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, hd", ARCH_HD)
def test_encoder_loss_and_every_gradient_match_jax(arch, hd):
    jcfg, cfg = _cfgs(arch, hd)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(hd))
    batch = next(jax_encoder_iter(jcfg, 2, 24, seed=hd))
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg, "cpu")
    params = _port_params(jparams, cfg)
    (loss, m), grads = gradlib.accumulate_grads(
        model.loss, params, {k: torch.as_tensor(v) for k, v in batch.items()},
        1, unread=model.unread_leaves())
    assert abs(float(loss) - float(jloss)) <= GRAD_TOL * abs(float(jloss))
    assert float(m["tokens"]) == float(jm["tokens"]) == batch["mask"].sum()
    want, got = _flat(jgrads), _flat(grads)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        assert _rel(w, got[path]) < GRAD_TOL, (path, _rel(w, got[path]))
    assert not want[EMBED].any() and not got[EMBED].any()
    me = "['frontend']['mask_embed']"
    assert np.abs(got[me]).max() > 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, hd", ARCH_HD)
def test_three_train_steps_match_jax(arch, hd):
    """Losses, grad norms and final parameters after 3 steps (the first at
    lr 0); AdamW decays the unread embedding as the JAX step does."""
    jcfg, cfg = _cfgs(arch, hd)
    jt, tt = _tcfgs()
    jparams = jax_build(jcfg).init(jax.random.key(hd))
    jopt = jadamw.init_state(jparams, jt.adamw)
    params = _port_params(jparams, cfg)
    opt = adamw.init_state(params, tt.adamw)
    embed0 = _flat(jparams)[EMBED]
    jstep = jax.jit(jprograms.build_train_step(jcfg, jt))
    step = programs.build_train_step(cfg, tt, "cpu")
    data = jax_encoder_iter(jcfg, 2, 24, seed=1)
    for _ in range(3):
        batch = next(data)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= \
                STEP_TOL * abs(float(jm[key])), key
    want, got = _flat(jparams), _flat(params)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=STEP_TOL,
                                   err_msg=path)
    assert not np.array_equal(want[EMBED], embed0)        # decayed


# ---------------------------------------------------------------------------
# the launcher, checkpoints, the trainer
# ---------------------------------------------------------------------------

def test_train_launcher_trains_an_encoder_and_restarts(tmp_path, capsys):
    """``launch/train.py`` at ``--device cpu``: 3 steps in one run, or 2,
    then 1 more from the checkpoint (the stream replays the 2 consumed
    batches): the same last loss and parameters."""
    from repro_torch.launch import train

    def run(d, steps):
        return train.main(["--arch", "hubert-xlarge", "--reduced",
                           "--device", "cpu", "--batch", "2", "--seq", "16",
                           "--steps", str(steps), "--ckpt-dir", str(d)])

    whole, hist = run(tmp_path / "a", 3)
    assert "final loss" in capsys.readouterr().out
    assert all(np.isfinite(hist["loss"])) and len(hist["loss"]) == 3
    run(tmp_path / "b", 2)
    again, rest = run(tmp_path / "b", 1)
    assert again.step == 3 and ck.latest_step(str(tmp_path / "b")) == 3
    assert rest["loss"][-1] == hist["loss"][-1]
    for a, b in zip(leaves(whole.params), leaves(again.params)):
        assert torch.equal(a, b)
    tree, _ = ck.restore(str(tmp_path / "b"))
    assert {"frontend", "head", "embed", "stack"} == set(tree["params"])
    assert {"frontend", "head"} <= set(tree["opt"]["m"])


def test_port_trainer_restores_a_jax_encoder_checkpoint(tmp_path):
    """The JAX trainer's step-0 encoder checkpoint (frontend, head, the
    unread embedding, fp32 AdamW state) restores into the port's
    ``Trainer`` leaf for leaf; one step on the same masked-prediction
    batch then gives JAX's loss, which it cannot with its features cast
    to integers (Queue C)."""
    jcfg, cfg = _cfgs("hubert-xlarge", 80)
    jt, tt = _tcfgs()
    jtr = JTrainer(jcfg, make_test_mesh(1, 1), jt, JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), log_every=1000))
    jtr.initialize(restore=False)
    jtr.maybe_checkpoint(force=True)
    jtr.checkpointer.wait()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ttr = Trainer(cfg, "cpu", tt, TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), log_every=1000))
    ttr.initialize(restore=True)
    want = _flat({"params": jtr.params, "opt": jtr.opt_state})
    got = _flat({"params": ttr.params, "opt": ttr.opt_state})
    assert sorted(want) == sorted(got)
    assert any("['frontend']" in p for p in got)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    batch = next(make_encoder_iterator(cfg, 2, 24, seed=7))
    jm = jtr.train_step(batch)
    m = ttr.train_step(batch)
    assert abs(m["loss"] - jm["loss"]) <= GRAD_TOL * abs(jm["loss"])


@pytest.mark.parametrize("hd", golden.ENCODER_HEAD_DIMS)
def test_golden_encoder_training_replays_on_the_cpu(tmp_path, hd):
    """The fixture's JAX encoder training run at head dim ``hd``, replayed
    by ``Trainer`` from its stored step-0 state, fed the file alone:
    losses and grad norms within 1e-4 relative, final parameters within
    1e-4.  ``chip_smoke.py`` replays it on the card through the
    kernels."""
    pre = f"encoder_train_{hd}_"
    with np.load(golden.PATH) as f:
        g = {k[len(pre):]: f[k] for k in f.files if k.startswith(pre)}
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    setup = json.loads(str(g["setup"]))
    assert cfg.head_dim == hd and cfg.encoder_only

    def tree(prefix):
        return from_numpy_tree(unflatten({k[len(prefix):]: v
                                          for k, v in g.items()
                                          if k.startswith(prefix)}),
                               cfg, "cpu")
    ck.save(str(tmp_path), 0, {"params": tree("params0/"), "opt": {
        "step": torch.tensor(0, dtype=torch.int32),
        "m": tree("opt0/m/"), "v": tree("opt0/v/")}}, {"step": 0})
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    tr = Trainer(cfg, "cpu", tcfg, TrainerConfig(ckpt_dir=str(tmp_path),
                                                 ckpt_every=0))
    tr.initialize(restore=True)
    data = make_encoder_iterator(cfg, setup["batch"], setup["seq"],
                                 seed=setup["seed"])
    ms = [tr.train_step(next(data)) for _ in range(setup["steps"])]
    np.testing.assert_allclose([m["loss"] for m in ms], g["losses"],
                               rtol=STEP_TOL)
    np.testing.assert_allclose([m["grad_norm"] for m in ms],
                               g["grad_norms"], rtol=STEP_TOL)
    want = _flat(tree("final/"))
    for path, p in flatten_with_path(tr.params):
        np.testing.assert_allclose(p.detach().numpy(), want[path], rtol=0,
                                   atol=STEP_TOL, err_msg=path)


# ---------------------------------------------------------------------------
# the Queue C faults
# ---------------------------------------------------------------------------

def test_trainer_keeps_each_batch_leaf_of_its_kind():
    """``Trainer.train_step`` hands the step an encoder batch with its f32
    features unchanged and its mask boolean, integer leaves as int64."""
    _, cfg = _cfgs("edge-cv-heavy", 48)
    tr = Trainer(cfg, "cpu", run_cfg=TrainerConfig(ckpt_every=0))
    tr.initialize(restore=False)
    seen = {}

    def spy(params, opt, batch):          # the step itself is not run
        seen.update(batch)
        return params, opt, {}
    tr.step_fn = spy
    batch = next(make_encoder_iterator(cfg, 2, 16))
    batch["mask"] = torch.as_tensor(batch["mask"])   # torch leaves too
    tr.train_step(batch)
    assert seen["features"].dtype == torch.float32
    np.testing.assert_array_equal(seen["features"].numpy(),
                                  batch["features"])
    assert seen["mask"].dtype == torch.bool
    assert torch.equal(seen["mask"], batch["mask"])
    assert seen["targets"].dtype == torch.int64
    np.testing.assert_array_equal(seen["targets"].numpy(), batch["targets"])


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_only_the_unread_embedding_gets_a_zero_gradient(monkeypatch,
                                                        num_microbatches):
    """An ``audio_frames`` encoder names its token embedding as its one
    unread leaf: ``accumulate_grads`` gives it zeros.  A leaf cut from
    the graph elsewhere still raises, and an embedding the forward does
    read (a decoder) is never unread."""
    from repro_torch.kernels import ops

    _, cfg = _cfgs("edge-cv-heavy", 48)
    model = Model(cfg, "cpu")
    assert model.unread_leaves() == (EMBED,)
    decoder = ModelConfig.from_dict(jax_reduced("tinyllama-1.1b").to_dict())
    assert Model(decoder, "cpu").unread_leaves() == ()
    params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in
             next(make_encoder_iterator(cfg, 4, 8)).items()}
    (_, _), grads = gradlib.accumulate_grads(
        model.loss, params, batch, num_microbatches,
        unread=model.unread_leaves())
    assert not grads["embed"]["embedding"].any()
    assert grads["frontend"]["w_frontend"].abs().max() > 0
    with pytest.raises(ValueError, match="no gradient"):
        gradlib.accumulate_grads(model.loss, params, batch, num_microbatches)
    attention = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: attention(*a, **kw).detach())
    with pytest.raises(ValueError, match="no gradient") as err:
        gradlib.accumulate_grads(model.loss, params, batch, num_microbatches,
                                 unread=model.unread_leaves())
    assert "['attn']['w_q']" in str(err.value)
    assert EMBED not in str(err.value)

"""The port's sharded training on 4 gloo ranks on the CPU, against the
JAX package's one-device train step (the GSPMD contract: a step on any
mesh gives what one device gives).

One spawn of 4 ranks (``torch_mesh_ranks.mesh_train``, about 30 s) runs
every mesh of this file, the SSM families' prefill and decode over split
caches (``SSM_CASES``) last; the JAX steps run here, in the parent, and
the ranks read their inputs (a step-0 checkpoint written from the JAX
parameters, the batches) from ``.npz`` and checkpoint files.  Bounds: the
metrics within ``METRIC_TOL`` relative and the parameters within
``PARAM_TOL`` of each leaf's largest entry, 1e-5 both: the ranks sum the
gradients in another order than one device (the metrics agree within
2e-7, most entries within 1e-7), and AdamW divides each gradient by its
own running magnitude, which turns the reordering into up to 3.6e-6 of a
leaf on the few entries whose gradients nearly cancel.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.data.tokens import make_lm_iterator as jax_lm_iterator
from repro.launch import programs as jprograms
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw, schedule as jsched
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.launch import programs
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.weights import from_numpy_tree
from repro_torch.optim import adamw, schedule
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, leaves, tree_map

import torch_mesh_ranks as ranks
import torch_port_golden as golden

torch.set_num_threads(1)

METRIC_TOL = 1e-5
PARAM_TOL = 1e-5
LR = 3e-4                              # AdamWConfig's default peak rate
# eps 1e-5: at 1e-6 an entry whose gradient nearly cancels (an embedding
# row two tokens pull apart) moves by 1.4e-5 of its leaf between the two
# summation orders; every other entry agrees within 1e-7
OPT = dict(adamw=dict(lr=LR, eps=1e-5),
           sched=dict(warmup_steps=2, decay_steps=20))
STEPS = 3


def _cfgs():
    tiny = dataclasses.replace(jreduced("tinyllama-1.1b"),
                               compute_dtype="float32")

    def cap(c):           # capacity factor E: no pair drops locally either
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.num_experts)))

    return {
        "tiny": (tiny, {}),
        "mixtral": (cap(dataclasses.replace(jreduced("mixtral-8x7b"),
                                            compute_dtype="float32")), {}),
        "deepseek": (cap(dataclasses.replace(jreduced("deepseek-v2-236b"),
                                             compute_dtype="float32")), {}),
        # 8 query heads over 2 KV heads on a model axis of 4: the KV heads
        # do not divide it and stay whole, each rank pairing its 2 query
        # heads with the one KV head they read
        "gqa": (dataclasses.replace(tiny, num_heads=8, num_kv_heads=2,
                                    head_dim=16), {}),
        # the SSM families split over the model axis: 16 Mamba2 heads, 8
        # a rank, and zamba2's shared attention block its 4 heads, 2 a
        # rank, sharded over data too
        "zamba2": (dataclasses.replace(jreduced("zamba2-1.2b"),
                                       compute_dtype="float32"), {}),
        "mamba2": (dataclasses.replace(jreduced("mamba2-2.7b"),
                                       compute_dtype="float32"), {}),
        # 15 heads (d_model 120) do not divide the axis: each rank runs
        # the whole layer, its cut conv and out_proj leaves gathered
        "mamba2_odd": (dataclasses.replace(jreduced("mamba2-2.7b",
                                                    d_model=120),
                                           compute_dtype="float32"), {}),
        "compress": (tiny, {"compress": True}),
        "int8": (tiny, {"state_dtype": "int8"}),
    }


RUNS = [
    dict(key="tiny22", spec="tiny", mesh=[2, 2], restore="ck_tiny",
         steps=STEPS, save="elastic", extra_step=True),
    dict(key="tiny41", spec="tiny", mesh=[4, 1], restore="ck_tiny",
         steps=STEPS),
    dict(key="mixtral22", spec="mixtral", mesh=[2, 2], restore="ck_mixtral",
         steps=STEPS),
    dict(key="deepseek22", spec="deepseek", mesh=[2, 2],
         restore="ck_deepseek", steps=STEPS),
    dict(key="gqa14", spec="gqa", mesh=[1, 4], restore="ck_gqa",
         steps=STEPS),
    dict(key="zamba222", spec="zamba2", mesh=[2, 2], restore="ck_zamba2",
         steps=STEPS),
    dict(key="mamba222", spec="mamba2", mesh=[2, 2], restore="ck_mamba2",
         steps=STEPS),
    dict(key="mamba2odd22", spec="mamba2_odd", mesh=[2, 2],
         restore="ck_mamba2_odd", steps=STEPS),
    dict(key="compress22", spec="compress", mesh=[2, 2],
         restore="ck_compress", steps=STEPS),
    dict(key="int822", spec="int8", mesh=[2, 2], restore="ck_int8",
         steps=STEPS),
    dict(key="elastic41", spec="tiny", mesh=[4, 1], restore="elastic",
         steps=0, extra_step=True),
]


# held against the port's own one-device step for the parameters: after
# 3 steps zamba2's conv_b already sits 1.6e-5 of the leaf from JAX's there
# (the scan's summation order)
PORT_PARAMS = ("zamba2", "mamba2", "mamba2_odd")

# the SSM families' prefill and decode on split caches: (config name of
# ``_cfgs``, mesh, B, prompt T, decode steps, max_seq)
SSM_CASES = {
    "mamba2_2x2": ("mamba2", (2, 2), 4, 11, 4, 32),
    "mamba2_1x4": ("mamba2", (1, 4), 4, 11, 4, 32),
    "zamba2_2x2": ("zamba2", (2, 2), 4, 11, 4, 32),
    "zamba2_1x4": ("zamba2", (1, 4), 4, 11, 4, 32),
    "mamba2_odd_2x2": ("mamba2_odd", (2, 2), 4, 11, 4, 32),
}


def _seeded(params, seed: int, name: str) -> dict:
    """``golden.seeded``, and for the SSM configs Mamba2's leaves that
    init makes zero or one and ``_SEEDED`` does not list (``conv_b``,
    ``out_norm``, ``d_skip``) seeded the same way: without them a rank
    that took the wrong channels of ``conv_b`` or ``out_norm`` would not
    show.  (A zero ``conv_b``'s largest entry after 3 steps is about two
    AdamW steps, 4.5e-4, and 1e-5 of that lies under the summation-order
    noise of any model-axis split: zamba2's came 2.5e-5 of the leaf off
    the one device, 8.3e-6 with only its attention, MLP and vocabulary
    split, its gradients within 7.5e-8 of one device's.)"""
    out = golden.seeded(params, seed)
    if name not in PORT_PARAMS:
        return out
    rng = np.random.default_rng(seed + 1)
    init = {"conv_b": 0.0, "out_norm": 1.0, "d_skip": 1.0}

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        if key in init:
            return (init[key] + 0.1 * rng.standard_normal(tree.shape)) \
                .astype(np.float32)
        return tree

    return walk(out)


def _train_configs(extra):
    aw = dict(OPT["adamw"], state_dtype=extra.get("state_dtype", "float32"))
    jt = jprograms.TrainConfig(adamw=jadamw.AdamWConfig(**aw),
                               sched=jsched.ScheduleConfig(**OPT["sched"]),
                               compress_grads=extra.get("compress", False))
    tt = programs.TrainConfig(adamw=adamw.AdamWConfig(**aw),
                              sched=schedule.ScheduleConfig(**OPT["sched"]),
                              compress_grads=extra.get("compress", False))
    return aw, jt, tt


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    want = {}
    for name, (jcfg, extra) in _cfgs().items():
        aw, jt, tt = _train_configs(extra)
        cfg = ModelConfig.from_dict(jcfg.to_dict())
        jparams = jax.tree.map(jnp.asarray, _seeded(
            jax_build(jcfg).init(jax.random.key(7)), 7, name))
        params = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
        ck.save(os.path.join(tmp, f"ck_{name}"), 0,
                {"params": params, "opt": adamw.init_state(params,
                                                           tt.adamw)},
                extra_meta={"step": 0})
        data = jax_lm_iterator(jcfg, 8, 16, seed=3)
        batches = [next(data) for _ in range(STEPS + 1)]
        np.savez(os.path.join(tmp, f"batches_{name}.npz"), **{
            f"{k}_{i}": v for i, b in enumerate(batches)
            for k, v in b.items()})
        with open(os.path.join(tmp, f"spec_{name}.json"), "w") as f:
            json.dump({"cfg": cfg.to_dict(), "adamw": aw,
                       "sched": OPT["sched"], "batches": name,
                       "compress": extra.get("compress", False)}, f)
        if name == "int8":
            continue              # held against the port's own one device
        jstep = jax.jit(jprograms.build_train_step(jcfg, jt))
        jopt = jadamw.init_state(jparams, jt.adamw)
        hist = []
        for b in batches[:STEPS]:
            jparams, jopt, m = jstep(jparams, jopt,
                                     {k: jnp.asarray(v) for k, v in b.items()})
            hist.append({k: float(v) for k, v in m.items()})
        want[name] = {"metrics": hist, "params": _flat(jparams)}
        if name in PORT_PARAMS:
            tr = Trainer(cfg, "cpu", tt, TrainerConfig(
                ckpt_dir=os.path.join(tmp, f"ck_{name}"), ckpt_every=0))
            tr.initialize(restore=True)
            for b in batches[:STEPS]:
                tr.train_step(b)
            want[name]["params"] = {
                p: v.detach().numpy() for p, v in flatten_with_path(tr.params)}
    with open(os.path.join(tmp, "runs.json"), "w") as f:
        json.dump(RUNS, f)
    want_ssm = _ssm_decode_inputs(tmp)
    ranks.spawn("mesh_train", tmp, 4, deadline=300)
    got = {r["key"]: ranks.load(tmp, r["key"]) for r in RUNS}
    for name in SSM_CASES:
        got[name] = ranks.load(tmp, f"cp_{name}_out")
    want.update(want_ssm)
    return tmp, want, got


def _ssm_decode_inputs(tmp):
    """``SSM_CASES``' JAX one-device prefill and greedy decode (fp32, from
    seeded parameters), and the ranks' inputs for ``cp_decode``: each
    config's parameters and prompt, the case list."""
    want, cases, runs = {}, [], {}
    for name, (spec, mesh, B, T, steps, S) in SSM_CASES.items():
        if spec not in runs:
            cfg = _cfgs()[spec][0]
            model = jax_build(cfg)
            flat = _seeded(jax.jit(model.init)(jax.random.key(0)), 0, spec)
            prompt = np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(B, T)).astype(np.int32)
            params = jax.tree.map(jnp.asarray, flat)
            caches = model.init_caches(B, S, jnp.float32)
            logits, caches, clen = jax.jit(model.prefill)(
                params, {"tokens": jnp.asarray(prompt)}, caches)
            decode = jax.jit(model.decode)
            got_l, got_t = [], []
            for i in range(steps + 1):
                got_l.append(np.asarray(logits, np.float32))
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                got_t.append(np.asarray(tok))
                if i < steps:
                    logits, caches = decode(params, tok, caches, clen)
                    clen = clen + 1
            runs[spec] = (np.stack(got_l), np.stack(got_t))
            np.savez(os.path.join(tmp, f"cp_{spec}.npz"), prompt=prompt,
                     **{"p/" + "/".join(k.key for k in path): np.asarray(v)
                        for path, v in jax.tree_util.tree_flatten_with_path(
                            flat)[0]})
            with open(os.path.join(tmp, f"cp_{spec}.json"), "w") as f:
                json.dump(cfg.to_dict(), f)
        want[name] = runs[spec]
        cases.append({"name": name, "spec": spec, "mesh": list(mesh),
                      "B": B, "S": S, "steps": steps, "caches": True})
    with open(os.path.join(tmp, "cp_cases.json"), "w") as f:
        json.dump(cases, f)
    return want


def _check_run(want, got, keys=("loss", "ce", "aux", "grad_norm"),
               flips=False):
    assert len(got["metrics"]) == len(want["metrics"])
    for w, g in zip(want["metrics"], got["metrics"]):
        for k in keys:
            assert abs(g[k] - w[k]) <= METRIC_TOL * max(abs(w[k]), 1e-6), \
                (k, g[k], w[k])
    assert sorted(got["params"]) == sorted(want["params"])
    for path, w in want["params"].items():
        d = np.abs(got["params"][path] - w)
        rel = d / max(np.abs(w).max(), 1e-6)
        if flips:
            # a gradient entry at an int8 rounding boundary of the
            # compressed payload may land on the next level
            assert (rel > PARAM_TOL).mean() <= 1e-4 and d.max() <= LR, \
                (path, float(rel.max()))
        else:
            assert rel.max() <= PARAM_TOL, (path, float(rel.max()))


@pytest.mark.parametrize("key, name", [
    ("tiny22", "tiny"), ("tiny41", "tiny"), ("mixtral22", "mixtral"),
    ("deepseek22", "deepseek"), ("zamba222", "zamba2"),
    ("mamba222", "mamba2"), ("mamba2odd22", "mamba2_odd")])
def test_sharded_train_steps_match_the_jax_one_device_step(mesh_runs, key,
                                                           name):
    """3 steps (the first at lr 0) of reduced fp32 tinyllama on (2, 2) and
    (4, 1), mixtral (expert parallel: 4 experts over a model axis of 2)
    deepseek (MLA, shared experts, the leading dense layer, remat
    ``"full"``), zamba2 and mamba2 (the Mamba2 heads and zamba2's shared
    attention block split over the model axis) and mamba2 at 15 heads
    (which do not divide it: the layer replicated) on (2, 2): losses, ce,
    aux and grad norms against the JAX one-device step, and the
    parameters gathered whole against it (the SSM families' against the
    port's one-device step, ``PORT_PARAMS``)."""
    _, want, got = mesh_runs
    run = got[key]
    assert run["mesh"] == dict(zip(("data", "model"),
                                   next(r["mesh"] for r in RUNS
                                        if r["key"] == key)))
    assert run["dtensors_whole"]          # Trainer.dtensors() places them
    if name in ("mixtral", "deepseek"):
        assert all(m["aux"] > 0 for m in run["metrics"])
    _check_run(want[name], run)


@pytest.mark.parametrize("name", sorted(SSM_CASES))
def test_ssm_split_prefill_and_decode_match_jax_one_device(mesh_runs, name):
    """Reduced fp32 mamba2 and zamba2 prefilled and decoded on (2, 2) and
    (1, 4), each rank on its heads, its caches JAX's shards (the SSM state
    over its heads, the conv tail an even cut of the channels, zamba2's k
    and v over the KV heads): every step's logits within 2e-4 relative of
    the JAX one-device decode, greedy tokens equal, and the caches
    gathered whole equal to one rank's within 1e-5 of each leaf's
    largest.  mamba2 at 15 heads runs the layer replicated, its SSM state
    whole and its conv tail still cut."""
    _, want, got = mesh_runs
    want_l, want_t = want[name]
    spec, mesh = SSM_CASES[name][:2]
    mamba = got[name]["cache_spec"]["mamba"]
    split = spec != "mamba2_odd"
    assert mamba["conv"][-1] == "model"
    assert (mamba["ssm"][-1] == "model") == split, mamba
    if spec == "zamba2":
        assert got[name]["cache_spec"]["attn"]["k"][-1] == "model"
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got[name]["logits"], want_l)]
    assert max(errs) < 2e-4, errs
    np.testing.assert_array_equal(got[name]["tokens"], want_t)
    assert max(got[name]["cache_err"].values()) <= 1e-5, \
        got[name]["cache_err"]


def test_gqa_pairing_with_kv_heads_that_do_not_divide_the_model_axis(
        mesh_runs):
    """8 query heads over 2 KV heads on (1, 4): the KV projections stay
    whole, each rank's 2 query heads read the one KV head the whole model
    pairs them with (``local_kv_heads``), and the KV leaves' gradients
    are summed over the axis: the steps match the JAX one-device step."""
    _, want, got = mesh_runs
    cfg = ModelConfig.from_dict(_cfgs()["gqa"][0].to_dict())
    assert [tattn.local_kv_heads(cfg, 4, r) for r in range(4)] == \
        [[0], [0], [1], [1]]
    wide = dataclasses.replace(cfg, num_heads=8, num_kv_heads=4)
    assert [tattn.local_kv_heads(wide, 2, r) for r in range(2)] == \
        [[0, 1], [2, 3]]
    one = dataclasses.replace(cfg, num_heads=12, num_kv_heads=2)
    assert tattn.local_kv_heads(one, 4, 1) == [0]      # inside one group
    odd = dataclasses.replace(cfg, num_heads=12, num_kv_heads=3)
    assert tattn.local_kv_heads(odd, 2, 0) == [0, 0, 0, 0, 1, 1]
    assert tattn.local_kv_heads(odd, 2, 1) == [1, 1, 2, 2, 2, 2]
    _check_run(want["gqa"], got["gqa14"])


def test_compress_grads_on_a_mesh(mesh_runs):
    """``TrainConfig.compress_grads`` on (2, 2): the int8 round trip over
    whole leaves, as the JAX step applies it.  The metrics hold to the
    bound; the quantizer is a step function, so a gradient entry that the
    reordering moves across a rounding boundary takes the next level: at
    most 1e-4 of a leaf's entries may pass the bound, each within the
    peak learning rate (1 entry of 32 768 in ``w_head`` does)."""
    _, want, got = mesh_runs
    _check_run(want["compress"], got["compress22"], flips=True)


def test_int8_moments_step_on_shards(mesh_runs):
    """int8 moments on (2, 2): each rank steps its rows of every leaf's
    blocks (``_step_int8_sharded``); against the port's one-device step
    from the same checkpoint: the metrics within the bound and the
    parameters within 2e-4 (a moment near a rounding step may land on
    the other level; PR-level bound of ``test_torch_moe_train``)."""
    tmp, _, got = mesh_runs
    cfg, extra = _cfgs()["int8"]
    _, _, tt = _train_configs(extra)
    tr = Trainer(ModelConfig.from_dict(cfg.to_dict()), "cpu", tt,
                 TrainerConfig(ckpt_dir=os.path.join(tmp, "ck_int8"),
                               ckpt_every=0))
    tr.initialize(restore=True)
    batches = np.load(os.path.join(tmp, "batches_int8.npz"))
    hist = [tr.train_step({k: batches[f"{k}_{i}"]
                           for k in ("tokens", "labels")})
            for i in range(STEPS)]
    run = got["int822"]
    for w, g in zip(hist, run["metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= METRIC_TOL * abs(w[k]), k
    for path, w in flatten_with_path(tr.params):
        np.testing.assert_allclose(run["params"][path], w.detach().numpy(),
                                   rtol=0, atol=2e-4, err_msg=path)
    assert isinstance(tr.opt_state["m"]["embed"]["embedding"],
                      adamw.QuantMoment)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``remat_policy`` none, minimal and full on one process: the loss
    and every gradient equal within 1e-6 of each leaf's largest (the
    recomputed forward is the same arithmetic)."""
    jcfg = dataclasses.replace(jreduced(arch), compute_dtype="float32")
    data = jax_lm_iterator(jcfg, 2, 16, seed=1)
    batch = {k: torch.tensor(np.asarray(v)).long()
             for k, v in next(data).items()}
    base = ModelConfig.from_dict(jcfg.to_dict())
    params = Model(base, "cpu").init(torch.Generator().manual_seed(0))
    out = {}
    for policy in ("none", "minimal", "full"):
        model = Model(dataclasses.replace(base, remat_policy=policy), "cpu")
        p2 = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
        loss, _ = model.loss(p2, batch)
        out[policy] = (float(loss.detach()),
                       torch.autograd.grad(loss, leaves(p2)))
    for policy in ("minimal", "full"):
        assert abs(out[policy][0] - out["none"][0]) <= 1e-6 * abs(
            out["none"][0])
        for a, b in zip(out["none"][1], out[policy][1]):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                float(a.abs().max()), 1e-12)


@pytest.mark.parametrize("policy", ["minimal", "full"])
def test_remat_recompute_keeps_the_forwards_rules(policy):
    """On the card the autograd engine recomputes a checkpointed layer on
    its own thread, where the thread-local sharding rules are not set; a
    backward taken on another thread here stands in for it: the
    recompute runs under the rules the forward saw (without them a
    sharded MoE layer took its local path there)."""
    import threading

    from repro_torch.distributed import sharding as tsh
    from repro_torch.models import transformer

    seen = []

    def block(x):
        seen.append(tsh.current_rules())
        return torch.sin(x @ x.T).sum(0)

    class ShapeOnly:
        shape = {"data": 2, "model": 2}

    cfg = dataclasses.replace(ModelConfig(), remat_policy=policy)
    x = torch.randn(4, 4, requires_grad=True)
    with tsh.use_rules(ShapeOnly()) as rules:
        y = transformer._remat(block, cfg, "train")(x).sum()
    out = {}
    t = threading.Thread(target=lambda: out.update(
        g=torch.autograd.grad(y, [x])[0]))
    t.start()
    t.join(60)
    assert not t.is_alive() and out["g"].shape == (4, 4)
    assert len(seen) == 2 and seen[0] is rules and seen[1] is rules


def test_elastic_restore_onto_another_mesh(mesh_runs, tmp_path):
    """Save on (2, 2), restore onto (4, 1) and onto one process: the
    parameters bit-equal to those saved, and the next step's loss and
    grad norm on each equal the unbroken (2, 2) run's within the bound."""
    tmp, _, got = mesh_runs
    saved, moved = got["tiny22"], got["elastic41"]
    assert moved["mesh"] == {"data": 4, "model": 1}
    for path, w in saved["params"].items():
        assert np.array_equal(moved["params"][path], w), path
    cfg, extra = _cfgs()["tiny"]
    _, _, tt = _train_configs(extra)
    tr = Trainer(ModelConfig.from_dict(cfg.to_dict()), "cpu", tt,
                 TrainerConfig(ckpt_dir=os.path.join(tmp, "elastic"),
                               ckpt_every=0))
    tr.initialize(restore=True)
    assert tr.step == STEPS
    for path, w in flatten_with_path(tr.params):
        assert np.array_equal(w.detach().numpy(), saved["params"][path]), \
            path
    batches = np.load(os.path.join(tmp, "batches_tiny.npz"))
    one = tr.train_step({k: batches[f"{k}_{STEPS}"]
                         for k in ("tokens", "labels")})
    for k in ("loss", "grad_norm"):
        want = saved["next"][k]
        for g in (moved["next"][k], one[k]):
            assert abs(g - want) <= METRIC_TOL * abs(want), (k, g, want)

"""Golden fixture linking the GPU port to the JAX reference.

Writes ``tests/data/torch_port_golden.npz``: the JAX package's reduced fp32
tinyllama parameters, four prompts, the JAX ``ServingEngine``'s greedy
token streams for them, and each prompt's last-position logits from JAX
``Model.forward``.  ``chip_smoke.py`` loads the file on the card (which has
no JAX) and checks that the port reproduces the streams there; a CPU test
regenerates the data and holds it against the committed file.

The prompts are served in two waves: the first prompt alone, then the
other three together.  The second wave's first prompt extends the first
prompt's first 35 tokens, so its admission attaches two shared pages and
copy-seeds a third from the radix tail (a mid-page COW).

A JAX training run rides along (``train_*``): the model and optimizer of
``tests/test_train_integration.py:17`` in fp32, with head_dim 32 in
place of 16 (the CUDA kernels take head dims 32, 64 and 128), from its
step-0 parameters and AdamW state, 5 steps of ``build_train_step`` on the
seeded bigram stream, each step's loss and grad norm, and the final
parameters.  ``chip_smoke.py`` replays it on the card through the
kernels.

The dense-slot plane rides along too (``ssm_*``, ``hybrid_*``): the JAX
engine's fp32 streams for reduced mamba2 and zamba2 at d_model 64
(zamba2 with 2 attention heads, so head_dim 32, a width the CUDA
attention kernels take), the four prompts served at once on two slots
in exact-length chunks of 16, each prompt's last-position logits from
JAX ``Model.forward``, and the parameters.  The JAX engine is warmed up
first, so its slot tree is in fp32 before the first insert.

The encoder family rides along (``encoder_48_*``, ``encoder_80_*``):
reduced fp32 ``edge-cv-heavy`` at head dims 48 and 80 (the widths the
CUDA forward gained for fig 3's apps and hubert-xlarge), 2 layers at
d_model 64, its JAX parameters, a batch of features [2, 40, 32] with
targets and a mask, JAX ``Model.forward``'s logits (without the mask, as
the container serves) and its masked-prediction loss.  ``chip_smoke.py``
replays them through the fp32 flash kernel.

Encoder training rides along (``encoder_train_48_*``,
``encoder_train_80_*``): the same reduced fp32 ``edge-cv-heavy`` at each
head dim, from its step-0 parameters and AdamW state, 5 steps of JAX
``build_train_step`` on ``make_encoder_iterator`` (masked prediction),
each step's loss and grad norm, and the final parameters.
``chip_smoke.py`` replays them on the card through the flash forward and
backward kernels.

The dense variants ride along (``dense_<arch>_*``): reduced fp32
``gemma-2b`` at head dim 256, ``command-r-35b`` (LayerNorm, parallel
blocks), ``chameleon-34b`` (qk-norm, ``vq_tokens``) and
``nemotron-4-340b`` at head dim 192 (LayerNorm, relu2), each from
``Model.init`` with its zero biases and unit norm scales replaced by
seeded nonzero values (``seeded``), the JAX engine's streams for the
waves and each prompt's last-position logits.  ``chip_smoke.py`` replays
them on the card through the kernels at head dims 256 and 192.

Mixtral rides along (``mixtral_*``): reduced fp32 ``mixtral-8x7b``
(window 32, 4 experts of 128, top 2, the default capacity factor 1.25)
from ``Model.init`` with its norm scales seeded, four prompts of 40-90
tokens (longer than the window, so the ring wraps in prefill and again
in decode) served at once on two dense slots by the warmed JAX engine,
its greedy streams and each prompt's last-position logits.
``chip_smoke.py`` replays them on the card through the fp32 windowed
flash and dense decode kernels.

DeepSeek rides along (``deepseek_*``): reduced fp32 ``deepseek-v2-236b``
(2 layers: the leading dense block with an MLP of 256, then one MoE block
of 4 experts of 128, top 2, with the shared expert; 4 heads) at the
published MLA widths (``kv_lora_rank`` 512, nope 128, rope 64, v 128;
``q_lora_rank`` 64), from ``Model.init`` with its norm scales seeded,
four prompts of 40-90 tokens served at once on two dense slots by the
warmed JAX engine (whole-prompt prefill in pow2 buckets), its greedy
streams and each prompt's last-position logits.  ``chip_smoke.py``
replays them on the card through the fp32 flash kernel at q/k 192 and v
128 and the dense decode kernel at keys 576 and values 512.

MoE and wide-head training rides along (``mixtral_train_*``,
``deepseek_train_*``, ``dense_gemma-2b_train_*``): 5 fp32 steps of JAX
``build_train_step`` on the seeded bigram stream from the parameters the
file already holds for reduced mixtral (``mixtral_params/``: batches of
48 tokens, past its window of 32), deepseek at the published MLA widths
(``deepseek_params/``, whose q/k 192 over v 128 reach the backward's
narrow-value pair, at capacity factor 0.25 so that pairs drop in the
dispatch) and gemma-2b at head dim 256 (``dense_gemma-2b_params/``),
with fresh AdamW state; each step's loss and grad norm, and the final
parameters.  ``params0_from`` names the prefix the step-0 parameters are
read from.  ``chip_smoke.py`` replays them on the card through the flash
forward and backward kernels at head dims 128 (windowed), 192/128 and
256.

The same waves are served again speculatively, with a random 1-layer,
1-head draft (seed 0, ``spec_k_max=3``), once over pages in the compute
dtype (``spec_streams_auto``) and once over int8 pages
(``spec_streams_int8``); the draft's config and parameters are stored
beside the target's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_port_golden.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

PATH = os.path.join(os.path.dirname(__file__), "data",
                    "torch_port_golden.npz")
ENGINE = dict(max_slots=2, max_seq=64, page_size=16, prefill_chunk=16,
              prefill_budget=16)
MAX_NEW = 8
DRAFT = dict(num_layers=1, num_heads=1, num_kv_heads=1, d_ff=32)
SPEC_K_MAX = 3
WAVES = [0, 1, 1, 1]
STATEFUL = {"ssm": ("mamba2-2.7b", dict(d_model=64)),
            "hybrid": ("zamba2-1.2b", dict(d_model=64, num_heads=2,
                                           num_kv_heads=2, d_ff=128))}
STATEFUL_ENGINE = dict(max_slots=2, max_seq=64, prefill_chunk=16,
                       prefill_budget=32)
ENCODER_HEAD_DIMS = (48, 80)
ENCODER_MODEL = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                     d_ff=128, vocab_size=64, frontend_dim=32)
ENCODER_BATCH = (2, 40)
ENCODER_TRAIN = dict(batch=4, seq=40, seed=5, steps=5,
                     adamw=dict(lr=3e-3, grad_clip_norm=1.0),
                     sched=dict(warmup_steps=2, decay_steps=200))
TRAIN_MODEL = dict(num_layers=2, d_model=64, head_dim=32, d_ff=128,
                   vocab_size=128)
TRAIN = dict(batch=8, seq=32, seed=3, steps=5,
             adamw=dict(lr=3e-3, grad_clip_norm=1.0),
             sched=dict(warmup_steps=5, decay_steps=200))
# reduced, at the real head dims where the CUDA kernels gained them
DENSE_VARIANTS = {"gemma-2b": dict(head_dim=256), "command-r-35b": {},
                  "chameleon-34b": {}, "nemotron-4-340b": dict(head_dim=192)}
MIXTRAL_ENGINE = dict(max_slots=2, max_seq=128, prefill_chunk=16)
MIXTRAL_MAX_NEW = 12
# MLA at its published widths over the reduced model (reduced() gives
# kv_lora_rank 32 and heads of 32 + 16)
DEEPSEEK_MLA = dict(q_lora_rank=64, kv_lora_rank=512, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128)
# the MoE and wide-head training runs: the arch's stored parameters
# (the prefix), the config override and the steps' setup
MOE_TRAIN = dict(batch=4, seq=48, seed=7, steps=5,
                 adamw=dict(lr=3e-3, grad_clip_norm=1.0),
                 sched=dict(warmup_steps=2, decay_steps=200))
MOE_TRAIN_RUNS = {"mixtral_train_": "mixtral_params/",
                  "deepseek_train_": "deepseek_params/",
                  "dense_gemma-2b_train_": "dense_gemma-2b_params/"}
DEEPSEEK_TRAIN_CAPACITY = 0.25
# leaves that init makes zero or one, which a test could not tell from
# missing: biases (and LayerNorm's) and norm scales
_SEEDED = {"b_q": 0.0, "b_k": 0.0, "b_v": 0.0, "b_o": 0.0, "bias": 0.0,
           "b_up": 0.0, "b_down": 0.0, "q_norm": 1.0, "k_norm": 1.0,
           "scale": 1.0}


def _prompts():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=40)
    return [base,
            np.concatenate([base[:35], rng.integers(0, 256, size=6)]),
            rng.integers(0, 256, size=23),
            rng.integers(0, 256, size=5)]


def seeded(params, seed: int) -> dict:
    """A float32 numpy copy of a params tree whose zero biases and unit
    norm scales (``_SEEDED``) are replaced by seeded nonzero values
    (``init + 0.1·N(0, 1)``), so that a comparison can see them."""
    rng = np.random.default_rng(seed)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        a = np.asarray(tree, np.float32)
        if key in _SEEDED:
            a = (_SEEDED[key] + 0.1 * rng.standard_normal(a.shape)) \
                .astype(np.float32)
        return a

    return walk(params)


def _serve(eng, prompts):
    """Serve the waves; the greedy streams in submission order."""
    for w in (0, 1):
        for p, pw in zip(prompts, WAVES):
            if pw == w:
                eng.submit(p, max_new_tokens=MAX_NEW)
        eng.run_until_drained()
    assert eng.kv.cow_copies == 1, eng.kv.cow_copies
    done = sorted(eng.completed.values(), key=lambda r: r.rid)
    return np.array([r.generated for r in done], np.int32)


def _flat_params(prefix: str, params) -> dict:
    import jax

    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params))[0]
    return {prefix + "/".join(k.key for k in path): leaf
            for path, leaf in flat}


def _train_run(pre: str, cfg, setup: dict, data, key: int,
               params=None, params_from: str = None) -> dict:
    """``setup["steps"]`` fp32 steps of JAX ``build_train_step`` on
    ``data`` from ``Model.init(key)``, or from ``params`` that the
    fixture already holds under ``params_from``: the config and setup,
    the step-0 parameters (or ``params0_from``) and AdamW moments, each
    step's loss and grad norm, and the final parameters, under keys that
    start with ``pre``."""
    import jax

    from repro.launch import programs
    from repro.models.model import build_model
    from repro.optim import adamw, schedule

    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    out = {pre + "config": np.array(json.dumps(cfg.to_dict(),
                                               sort_keys=True)),
           pre + "setup": np.array(json.dumps(setup, sort_keys=True))}
    if params is None:
        params = build_model(cfg).init(jax.random.key(key))
        out.update(_flat_params(pre + "params0/", params))
    else:
        out[pre + "params0_from"] = np.array(params_from)
    opt = adamw.init_state(params, tcfg.adamw)
    out.update(_flat_params(pre + "opt0/m/", opt["m"]))
    out.update(_flat_params(pre + "opt0/v/", opt["v"]))
    step = jax.jit(programs.build_train_step(cfg, tcfg))
    losses, norms = [], []
    for _ in range(setup["steps"]):
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[pre + "losses"] = np.array(losses, np.float32)
    out[pre + "grad_norms"] = np.array(norms, np.float32)
    out.update(_flat_params(pre + "final/", params))
    return out


def _train() -> dict:
    """The JAX training runs of the module docstring: the decoder's
    (``train_*``) and the encoder's at each head dim
    (``encoder_train_<hd>_*``)."""
    from repro.configs import get_reduced_config
    from repro.data.tokens import make_encoder_iterator, make_lm_iterator

    cfg = dataclasses.replace(
        get_reduced_config("tinyllama-1.1b", **TRAIN_MODEL),
        compute_dtype="float32")
    out = _train_run("train_", cfg, TRAIN, make_lm_iterator(
        cfg, TRAIN["batch"], TRAIN["seq"], seed=TRAIN["seed"]), key=0)
    e = ENCODER_TRAIN
    for hd in ENCODER_HEAD_DIMS:
        cfg = dataclasses.replace(
            get_reduced_config("edge-cv-heavy", head_dim=hd,
                               **ENCODER_MODEL), compute_dtype="float32")
        out.update(_train_run(f"encoder_train_{hd}_", cfg, e,
                              make_encoder_iterator(cfg, e["batch"],
                                                    e["seq"],
                                                    seed=e["seed"]),
                              key=hd))
    return out


def moe_train() -> dict:
    """The MoE and wide-head training runs of the module docstring, from
    the parameters ``_mixtral``, ``_deepseek`` and ``_dense_variants``
    store."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.data.tokens import make_lm_iterator
    from repro.models.config import MLAConfig
    from repro.models.model import build_model

    mix = dataclasses.replace(get_reduced_config("mixtral-8x7b"),
                              compute_dtype="float32")
    ds = dataclasses.replace(
        get_reduced_config("deepseek-v2-236b",
                           mla=MLAConfig(**DEEPSEEK_MLA)),
        compute_dtype="float32")
    gemma = dataclasses.replace(
        get_reduced_config("gemma-2b", **DENSE_VARIANTS["gemma-2b"]),
        compute_dtype="float32")
    runs = {"mixtral_train_": (mix, 11, mix),
            "deepseek_train_": (ds, 12, dataclasses.replace(
                ds, moe=dataclasses.replace(
                    ds.moe, capacity_factor=DEEPSEEK_TRAIN_CAPACITY))),
            "dense_gemma-2b_train_": (gemma, list(DENSE_VARIANTS).index(
                "gemma-2b"), gemma)}
    out, t = {}, MOE_TRAIN
    for pre, (cfg, seed, train_cfg) in runs.items():
        params = jax.tree.map(jnp.asarray, seeded(
            build_model(cfg).init(jax.random.key(seed)), seed=seed))
        out.update(_train_run(
            pre, train_cfg, t, make_lm_iterator(train_cfg, t["batch"],
                                                t["seq"], seed=t["seed"]),
            key=seed, params=params, params_from=MOE_TRAIN_RUNS[pre]))
    return out


def _stateful() -> dict:
    """The dense-slot streams of the module docstring."""
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.serving.engine import ServingEngine

    out = {"stateful_engine": np.array(json.dumps(STATEFUL_ENGINE,
                                                  sort_keys=True))}
    for fam, (arch, over) in STATEFUL.items():
        cfg = dataclasses.replace(get_reduced_config(arch, **over),
                                  compute_dtype="float32")
        eng = ServingEngine(cfg, seed=0, **STATEFUL_ENGINE).warmup()
        for p in _prompts():
            eng.submit(p, max_new_tokens=MAX_NEW)
        eng.run_until_drained()
        done = sorted(eng.completed.values(), key=lambda r: r.rid)
        out[f"{fam}_config"] = np.array(json.dumps(cfg.to_dict(),
                                                   sort_keys=True))
        out[f"{fam}_streams"] = np.array([r.generated for r in done],
                                         np.int32)
        out[f"{fam}_first_logits"] = np.stack([np.asarray(
            eng.model.forward(eng.params, {"tokens": jnp.asarray(
                p[None], jnp.int32)})[0])[0, -1]
            for p in _prompts()]).astype(np.float32)
        out.update(_flat_params(f"{fam}_params/", eng.params))
    return out


def _encoder() -> dict:
    """The encoder logits of the module docstring."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.model import build_model

    out = {}
    B, T = ENCODER_BATCH
    for hd in ENCODER_HEAD_DIMS:
        cfg = dataclasses.replace(
            get_reduced_config("edge-cv-heavy", head_dim=hd,
                               **ENCODER_MODEL), compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(jax.random.key(hd))
        rng = np.random.default_rng(hd)
        feats = rng.normal(size=(B, T, cfg.frontend_dim)).astype(np.float32)
        targets = rng.integers(0, cfg.vocab_size, size=(B, T)) \
            .astype(np.int32)
        mask = rng.random((B, T)) < 0.25
        logits, _ = model.forward(params, {"features": jnp.asarray(feats)})
        loss, _ = model.loss(params, {"features": jnp.asarray(feats),
                                      "targets": jnp.asarray(targets),
                                      "mask": jnp.asarray(mask)})
        pre = f"encoder_{hd}_"
        out[pre + "config"] = np.array(json.dumps(cfg.to_dict(),
                                                  sort_keys=True))
        out[pre + "features"] = feats
        out[pre + "targets"] = targets
        out[pre + "mask"] = mask
        out[pre + "logits"] = np.asarray(logits, np.float32)
        out[pre + "loss"] = np.array(float(loss), np.float32)
        out.update(_flat_params(pre + "params/", params))
    return out


def _dense_variants() -> dict:
    """The dense variants' streams and logits of the module docstring."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.model import build_model
    from repro.serving.engine import ServingEngine

    out = {}
    for i, (arch, over) in enumerate(DENSE_VARIANTS.items()):
        cfg = dataclasses.replace(get_reduced_config(arch, **over),
                                  compute_dtype="float32")
        params = jax.tree.map(jnp.asarray, seeded(
            build_model(cfg).init(jax.random.key(i)), seed=i))
        eng = ServingEngine(cfg, params=params, **ENGINE)
        pre = f"dense_{arch}_"
        out[pre + "config"] = np.array(json.dumps(cfg.to_dict(),
                                                  sort_keys=True))
        out[pre + "streams"] = _serve(eng, _prompts())
        out[pre + "first_logits"] = np.stack([np.asarray(eng.model.forward(
            params, {"tokens": jnp.asarray(p[None], jnp.int32)})[0])[0, -1]
            for p in _prompts()]).astype(np.float32)
        out.update(_flat_params(pre + "params/", params))
    return out


def _padded(prompts) -> tuple:
    lens = np.array([len(p) for p in prompts], np.int32)
    padded = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    return padded, lens


def _mixtral() -> dict:
    """The mixtral streams and logits of the module docstring."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.model import build_model
    from repro.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"),
                              compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, seeded(
        build_model(cfg).init(jax.random.key(11)), seed=11))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=int(n))
               for n in rng.integers(40, 91, size=4)]
    eng = ServingEngine(cfg, params=params, **MIXTRAL_ENGINE).warmup()
    for p in prompts:
        eng.submit(p, max_new_tokens=MIXTRAL_MAX_NEW)
    eng.run_until_drained()
    done = sorted(eng.completed.values(), key=lambda r: r.rid)
    padded, lens = _padded(prompts)
    out = {"config": np.array(json.dumps(cfg.to_dict(), sort_keys=True)),
           "engine": np.array(json.dumps(MIXTRAL_ENGINE, sort_keys=True)),
           "prompts": padded, "prompt_lens": lens,
           "max_new": np.array(MIXTRAL_MAX_NEW, np.int32),
           "streams": np.array([r.generated for r in done], np.int32),
           "last_logits": np.stack([np.asarray(eng.model.forward(
               params, {"tokens": jnp.asarray(p[None], jnp.int32)})[0])[0, -1]
               for p in prompts]).astype(np.float32)}
    out = {"mixtral_" + k: v for k, v in out.items()}
    out.update(_flat_params("mixtral_params/", params))
    return out


def _deepseek() -> dict:
    """The deepseek streams and logits of the module docstring."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.config import MLAConfig
    from repro.models.model import build_model
    from repro.serving.engine import ServingEngine

    cfg = dataclasses.replace(
        get_reduced_config("deepseek-v2-236b",
                           mla=MLAConfig(**DEEPSEEK_MLA)),
        compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, seeded(
        build_model(cfg).init(jax.random.key(12)), seed=12))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, size=int(n))
               for n in rng.integers(40, 91, size=4)]
    eng = ServingEngine(cfg, params=params, **MIXTRAL_ENGINE).warmup()
    for p in prompts:
        eng.submit(p, max_new_tokens=MIXTRAL_MAX_NEW)
    eng.run_until_drained()
    done = sorted(eng.completed.values(), key=lambda r: r.rid)
    padded, lens = _padded(prompts)
    out = {"config": np.array(json.dumps(cfg.to_dict(), sort_keys=True)),
           "engine": np.array(json.dumps(MIXTRAL_ENGINE, sort_keys=True)),
           "prompts": padded, "prompt_lens": lens,
           "max_new": np.array(MIXTRAL_MAX_NEW, np.int32),
           "streams": np.array([r.generated for r in done], np.int32),
           "last_logits": np.stack([np.asarray(eng.model.forward(
               params, {"tokens": jnp.asarray(p[None], jnp.int32)})[0])[0, -1]
               for p in prompts]).astype(np.float32)}
    out = {"deepseek_" + k: v for k, v in out.items()}
    out.update(_flat_params("deepseek_params/", params))
    return out


def make() -> dict:
    """Regenerate the fixture's arrays with the JAX package."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.model import build_model
    from repro.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    dcfg = dataclasses.replace(cfg, **DRAFT)
    eng = ServingEngine(cfg, seed=0, **ENGINE)
    dparams = build_model(dcfg).init(jax.random.key(0))
    prompts = _prompts()
    streams = _serve(eng, prompts)
    spec = {kv: _serve(ServingEngine(cfg, params=eng.params, **ENGINE,
                                     kv_dtype=kv, draft_cfg=dcfg,
                                     draft_params=dparams,
                                     spec_k_max=SPEC_K_MAX), prompts)
            for kv in ("auto", "int8")}
    first = [np.asarray(eng.model.forward(
        eng.params, {"tokens": jnp.asarray(p[None], jnp.int32)})[0])[0, -1]
        for p in prompts]
    padded, lens = _padded(prompts)
    out = {
        "config": np.array(json.dumps(cfg.to_dict(), sort_keys=True)),
        "engine": np.array(json.dumps(ENGINE, sort_keys=True)),
        "prompts": padded,
        "prompt_lens": lens,
        "waves": np.array(WAVES, np.int32),
        "max_new": np.array(MAX_NEW, np.int32),
        "streams": streams,
        "first_logits": np.stack(first).astype(np.float32),
        "draft_config": np.array(json.dumps(dcfg.to_dict(), sort_keys=True)),
        "spec_k_max": np.array(SPEC_K_MAX, np.int32),
        "spec_streams_auto": spec["auto"],
        "spec_streams_int8": spec["int8"],
    }
    out.update(_flat_params("params/", eng.params))
    out.update(_flat_params("draft_params/", dparams))
    out.update(_train())
    out.update(_stateful())
    out.update(_encoder())
    out.update(_dense_variants())
    out.update(_mixtral())
    out.update(_deepseek())
    out.update(moe_train())
    return out


def write(path: str = PATH) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make())


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    write()
    print(f"wrote {PATH}")

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
TRAIN_MODEL = dict(num_layers=2, d_model=64, head_dim=32, d_ff=128,
                   vocab_size=128)
TRAIN = dict(batch=8, seq=32, seed=3, steps=5,
             adamw=dict(lr=3e-3, grad_clip_norm=1.0),
             sched=dict(warmup_steps=5, decay_steps=200))


def _prompts():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=40)
    return [base,
            np.concatenate([base[:35], rng.integers(0, 256, size=6)]),
            rng.integers(0, 256, size=23),
            rng.integers(0, 256, size=5)]


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


def _train() -> dict:
    """The JAX training run of the module docstring."""
    import jax

    from repro.configs import get_reduced_config
    from repro.data.tokens import make_lm_iterator
    from repro.launch import programs
    from repro.models.model import build_model
    from repro.optim import adamw, schedule

    cfg = dataclasses.replace(
        get_reduced_config("tinyllama-1.1b", **TRAIN_MODEL),
        compute_dtype="float32")
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**TRAIN["adamw"]),
        sched=schedule.ScheduleConfig(**TRAIN["sched"]))
    params = build_model(cfg).init(jax.random.key(0))
    opt = adamw.init_state(params, tcfg.adamw)
    out = {"train_config": np.array(json.dumps(cfg.to_dict(),
                                               sort_keys=True)),
           "train_setup": np.array(json.dumps(TRAIN, sort_keys=True))}
    out.update(_flat_params("train_params0/", params))
    out.update(_flat_params("train_opt0/m/", opt["m"]))
    out.update(_flat_params("train_opt0/v/", opt["v"]))
    step = jax.jit(programs.build_train_step(cfg, tcfg))
    data = make_lm_iterator(cfg, TRAIN["batch"], TRAIN["seq"],
                            seed=TRAIN["seed"])
    losses, norms = [], []
    for _ in range(TRAIN["steps"]):
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["train_losses"] = np.array(losses, np.float32)
    out["train_grad_norms"] = np.array(norms, np.float32)
    out.update(_flat_params("train_final/", params))
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
    lens = np.array([len(p) for p in prompts], np.int32)
    padded = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
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
    return out


def write(path: str = PATH) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make())


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    write()
    print(f"wrote {PATH}")

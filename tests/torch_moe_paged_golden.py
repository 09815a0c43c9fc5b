"""Golden fixture of a full-attention MoE on the paged data plane, from
the JAX package, for the card.

Writes ``tests/data/torch_moe_paged_golden.npz``: reduced fp32
``mixtral-8x7b`` with full attention (no window) and one leading dense
layer, as a stored config and a parameter spec with its seed (the port
draws the parameters with ``torch_port_golden.draw``: no parameter is
stored), the prompts of two waves (the second wave's first prompt
extends the first prompt's first 35 tokens, three into the partial page
the radix holds of it, so its admission attaches 2 shared pages and
copies the third), and the JAX engine's greedy streams and counters for
five runs on pages of 16, in chunks of 16: plain, over int8 pages, speculative over int8 pages
with a 1-layer tinyllama-shaped draft (its own spec and seed),
speculative with the target as its own draft (acceptance near 1), and
plain at capacity factor 0.25, where the experts drop real tokens of
the padded prefill chunks and of the decode ticks.  ``chip_smoke.py`` replays every run on the card through
the kernels; ``tests/test_torch_moe_paged.py`` regenerates the arrays
and holds them against the committed file, and replays them on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_golden as base  # noqa: E402

PATH = os.path.join(os.path.dirname(__file__), "data",
                    "torch_moe_paged_golden.npz")
ENGINE = dict(max_slots=3, max_seq=128, page_size=16, prefill_chunk=16)
MAX_NEW = 8
SEED, DRAFT_SEED = 17, 18
DRAFT = dict(num_layers=1)
SPEC_K_MAX = 3
WAVES = [0, 1, 1, 1]
# the runs: name → engine knobs beyond ENGINE (``drops``: the experts'
# capacity factor 0.25 in place of 1.25)
RUNS = {"plain": {}, "int8": dict(kv_dtype="int8"),
        "spec_int8": dict(kv_dtype="int8", draft=True),
        "spec_self": dict(draft="self"), "drops": dict(drops=True)}
STATS = ("cow_copies", "kv_prefix_hits", "kv_prefix_misses", "preemptions",
         "spec_rounds", "spec_accepted", "pages_in_use")


def prompts():
    rng = np.random.default_rng(SEED)
    first = rng.integers(0, 256, size=40)
    return [first,
            np.concatenate([first[:35], rng.integers(0, 256, size=22)]),
            rng.integers(0, 256, size=41),
            rng.integers(0, 256, size=7)]


def config(reduced, replace):
    """The JAX (or the port's) config: reduced mixtral-8x7b in fp32, full
    attention, one leading dense layer of d_ff 256."""
    cfg = reduced("mixtral-8x7b")
    moe = replace(cfg.moe, first_dense_layers=1, first_dense_d_ff=256)
    return replace(cfg, attn_type="full", sliding_window=0,
                   compute_dtype="float32", moe=moe)


def draft_config(reduced, replace):
    return replace(reduced("tinyllama-1.1b"), compute_dtype="float32",
                   **DRAFT)


def with_drops(cfg, replace):
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=0.25))


def run_setup(name, cfg, params, dcfg, dparams, replace):
    """Run ``name``'s (config, engine keywords beyond ``ENGINE``), for
    either package: the target ``cfg`` and ``params``, the draft's
    ``dcfg`` and ``dparams``, ``dataclasses.replace``."""
    knobs = RUNS[name]
    kw = {"kv_dtype": knobs.get("kv_dtype", "auto")}
    if knobs.get("draft"):
        own = knobs["draft"] == "self"
        kw.update(draft_cfg=cfg if own else dcfg,
                  draft_params=params if own else dparams,
                  spec_k_max=SPEC_K_MAX)
    return (with_drops(cfg, replace) if knobs.get("drops") else cfg), kw


def serve(eng, prompts_, max_new=MAX_NEW):
    """Serve the waves; the greedy streams in submission order."""
    for w in (0, 1):
        for p, pw in zip(prompts_, WAVES):
            if pw == w:
                eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
    done = sorted(eng.completed.values(), key=lambda r: r.rid)
    return np.array([r.generated for r in done], np.int32)


def make() -> dict:
    """Regenerate the fixture's arrays with the JAX package."""
    import jax

    from repro.configs import get_reduced_config
    from repro.models.model import build_model
    from repro.serving.engine import ServingEngine

    rep = dataclasses.replace
    cfg = config(get_reduced_config, rep)
    dcfg = draft_config(get_reduced_config, rep)
    spec = base.spec_of(build_model(cfg).init(jax.random.key(SEED)))
    dspec = base.spec_of(build_model(dcfg).init(jax.random.key(DRAFT_SEED)))
    params = base._unflat(base.draw(spec, SEED))
    dparams = base._unflat(base.draw(dspec, DRAFT_SEED))
    padded, lens = base._padded(prompts())
    out = {"config": np.array(json.dumps(cfg.to_dict(), sort_keys=True)),
           "draft_config": np.array(json.dumps(dcfg.to_dict(),
                                               sort_keys=True)),
           "engine": np.array(json.dumps(ENGINE, sort_keys=True)),
           "params_spec": np.array(spec), "params_seed": np.array(SEED),
           "draft_spec": np.array(dspec),
           "draft_seed": np.array(DRAFT_SEED),
           "prompts": padded, "prompt_lens": lens,
           "max_new": np.array(MAX_NEW, np.int32),
           "spec_k_max": np.array(SPEC_K_MAX, np.int32)}
    for name in RUNS:
        c, kw = run_setup(name, cfg, params, dcfg, dparams, rep)
        eng = ServingEngine(c, params=params, **ENGINE, **kw).warmup()
        out[f"{name}_streams"] = serve(eng, prompts())
        st = eng.stats()
        out[f"{name}_stats"] = np.array(json.dumps(
            {k: st.get(k, 0) for k in STATS}, sort_keys=True))
    return out


def write(path: str = PATH) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make())


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    write()
    print(f"wrote {PATH}")

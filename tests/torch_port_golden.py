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


def _prompts():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=40)
    return [base,
            np.concatenate([base[:35], rng.integers(0, 256, size=6)]),
            rng.integers(0, 256, size=23),
            rng.integers(0, 256, size=5)]


def make() -> dict:
    """Regenerate the fixture's arrays with the JAX package."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    eng = ServingEngine(cfg, seed=0, **ENGINE)
    prompts = _prompts()
    waves = [0, 1, 1, 1]
    for w in (0, 1):
        for p, pw in zip(prompts, waves):
            if pw == w:
                eng.submit(p, max_new_tokens=MAX_NEW)
        eng.run_until_drained()
    done = sorted(eng.completed.values(), key=lambda r: r.rid)
    assert eng.kv.cow_copies == 1, eng.kv.cow_copies
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
        "waves": np.array(waves, np.int32),
        "max_new": np.array(MAX_NEW, np.int32),
        "streams": np.array([r.generated for r in done], np.int32),
        "first_logits": np.stack(first).astype(np.float32),
    }
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32), eng.params))[0]
    for path, leaf in flat:
        out["params/" + "/".join(k.key for k in path)] = leaf
    return out


def write(path: str = PATH) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make())


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    write()
    print(f"wrote {PATH}")

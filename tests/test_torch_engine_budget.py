"""``prefill_budget="auto"`` on the port's ``ServingEngine``, as the JAX
engine serves it: a provisional budget of two chunks, refined by
``warmup()`` on the paged plane from timed chunk and decode walls, kept
on dense slots; the request completes through ``run_until_drained`` and
through the background loop, with the JAX engine's greedy fp32 tokens.
Any other string raises at construction."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_numpy_tree
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

KW = dict(max_slots=2, max_seq=64, prefill_budget="auto")
PROMPT = np.arange(3, 11)                # one 8-token prompt


def _cfgs():
    jcfg = dataclasses.replace(jax_reduced("tinyllama-1.1b"),
                               compute_dtype="float32")
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _engine(**kw):
    return ServingEngine(_cfgs()[1], device="cpu", seed=2, **{**KW, **kw})


def test_auto_budget_is_provisional_then_autotuned_on_pages():
    eng = _engine()
    chunk = eng.chunk_tokens
    assert eng.paged and eng.prefill_budget == 2 * chunk
    pools = {k: v.clone() for k, v in eng.kv.pools["attn"].items()}
    eng.warmup()
    budget = eng.prefill_budget
    assert isinstance(budget, int) and budget % chunk == 0
    assert chunk <= budget <= 8 * chunk
    # the timed runs are state-neutral: only trash page 0 was written
    for k, v in eng.kv.pools["attn"].items():
        assert torch.equal(v[:, 1:], pools[k][:, 1:])
    assert int(eng.kv.cache_len.abs().sum()) == 0
    eng.warmup()                             # idempotent
    assert eng.prefill_budget == budget


def test_auto_budget_stays_provisional_on_dense_slots():
    eng = _engine(paged=False)
    before = eng.prefill_budget
    assert before == 2 * eng.chunk_tokens
    eng.warmup()
    assert eng.prefill_budget == before


@pytest.mark.parametrize("mode", ["run_until_drained", "start"])
def test_auto_budget_serves_a_request(mode):
    eng = _engine()
    if mode == "run_until_drained":
        eng.submit(PROMPT, max_new_tokens=4)
        done = eng.run_until_drained()
    else:
        with eng:
            done = [eng.submit(PROMPT, max_new_tokens=4).result(timeout=60)]
    assert len(done) == 1 and len(done[0].generated) == 4
    assert not eng.failed and eng.stats()["failed"] == 0


@pytest.mark.parametrize("paged", [True, False])
def test_auto_budget_streams_equal_jax_engine(paged):
    jcfg, tcfg = _cfgs()
    kw = dict(KW, paged=paged)
    je = JaxEngine(jcfg, seed=3, **kw)
    params = from_numpy_tree(jax.tree.map(np.asarray, je.params), tcfg,
                             "cpu")
    te = ServingEngine(tcfg, params=params, device="cpu", **kw)
    streams = []
    for eng in (je, te):
        eng.warmup()
        eng.submit(PROMPT, max_new_tokens=6)
        streams.append([list(map(int, r.generated))
                        for r in eng.run_until_drained()])
    assert streams[1] == streams[0] and len(streams[0][0]) == 6


@pytest.mark.parametrize("budget", ["AUTO", "fast", 1.5, True])
def test_other_non_integer_budgets_raise_at_construction(budget):
    with pytest.raises(ValueError, match="prefill_budget"):
        _engine(prefill_budget=budget)

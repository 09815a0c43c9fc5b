"""Decode and cache fill over KV caches split along the sequence, on 4
gloo ranks on the CPU, against the JAX package's one-device decode.

``cache_partition_specs`` puts a dense cache's sequence on the ``model``
axis when its KV heads do not divide the axis, and MLA's latent pair
always.  Each rank then holds every KV head's keys for its block of
positions: a prefill writes the positions of its block, a decode step
writes the new token on the rank that owns its slot, computes every
query head's partial attention over its block with the log-sum-exp
(``ops.decode_attention_lse``) and merges the partials across the axis
(``spmd.merge_partials``).  One spawn of 4 ranks
(``torch_mesh_ranks.cp_decode``) runs every case; the JAX prefill and
greedy decode run here, in fp32, from the same parameters (exported
through ``repro_torch.models.weights``).  Bounds: logits within 2e-4
relative at every step (``tests/test_decode_consistency.py:42``), greedy
tokens equal; the plain ``decode_attention``'s log-sum-exp within 2e-5
of its closed form.
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
from repro.models.model import build_model as jax_build
from repro_torch.distributed import spmd
from repro_torch.kernels import ops, ref

import torch_mesh_ranks as ranks
import torch_port_golden as golden

torch.set_num_threads(1)

LOGIT_TOL = 2e-4
LSE_TOL = 2e-5


def _cap(c):
    """Capacity factor E: no MoE pair drops on one device or on a rank."""
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=float(c.moe.num_experts)))


def _fp32(name, **over):
    return dataclasses.replace(jreduced(name, **over),
                               compute_dtype="float32")


# name: (config, mesh (data, model), B, prompt T, decode steps, max_seq)
CASES = {
    # 4 query heads over one KV head: the heads split over model, the
    # cache along the sequence
    "gemma_2x2": (_fp32("gemma-2b"), (2, 2), 4, 12, 8, 32),
    "gemma_1x4": (_fp32("gemma-2b"), (1, 4), 4, 12, 8, 32),
    # the reduced config's 4 KV heads divide the axis; 2 do not
    "tinyllama_kv2": (_fp32("tinyllama-1.1b", num_kv_heads=2), (1, 4), 4,
                      12, 8, 32),
    # MLA's latent pair, always split along the sequence
    "deepseek": (_cap(_fp32("deepseek-v2-236b")), (1, 4), 4, 12, 8, 32),
    # a sliding-window ring of 32 (8 slots a rank) that a 40-token prompt
    # wraps, and the decode steps wrap again
    "mixtral_ring": (_cap(_fp32("mixtral-8x7b", num_kv_heads=2)), (1, 4),
                     2, 40, 8, 64),
}


@pytest.fixture(scope="module")
def cp_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cp_decode"))
    want, cases = {}, []
    for name, (cfg, mesh, B, T, steps, S) in CASES.items():
        model = jax_build(cfg)
        flat = golden.seeded(jax.jit(model.init)(jax.random.key(0)), 0)
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
        want[name] = (np.stack(got_l), np.stack(got_t))
        np.savez(os.path.join(tmp, f"cp_{name}.npz"), prompt=prompt,
                 **{f"p/{k}": v for k, v in _flat(flat).items()})
        with open(os.path.join(tmp, f"cp_{name}.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
        cases.append({"name": name, "mesh": list(mesh), "B": B, "S": S,
                      "steps": steps})
    with open(os.path.join(tmp, "cp_cases.json"), "w") as f:
        json.dump(cases, f)
    ranks.spawn("cp_decode", tmp, 4, deadline=240)
    return {name: (want[name], ranks.load(tmp, f"cp_{name}_out"))
            for name in CASES}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_cache_decode_matches_jax_one_device(cp_runs, name):
    (want_l, want_t), got = cp_runs[name]
    # the case reaches the sequence split: every cache leaf's sequence
    # dim (after the layer and batch dims) on the model axis
    for leaf_specs in got["cache_spec"].values():
        for spec in leaf_specs.values():
            assert len(spec) >= 3 and spec[2] == "model", spec
    assert got["logits"].shape == want_l.shape
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got["logits"], want_l)]
    assert max(errs) < LOGIT_TOL, errs
    np.testing.assert_array_equal(got["tokens"], want_t)


def _closed_form(q, k, v, clen, softcap, window, scale):
    """Each row's log-sum-exp of its scaled (capped) valid logits, in
    float64; NEG_INF for a row with none."""
    q, k = np.asarray(q, np.float64), np.asarray(k, np.float64)
    B, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    out = np.full((B, Hq), ref.NEG_INF)
    for b in range(B):
        lo = max(0, int(clen[b]) - window) if window else 0
        keys = range(lo, min(int(clen[b]), S))
        for h in range(Hq):
            if not keys:
                continue
            s = np.array([q[b, h] @ k[b, j, h // G] * scale for j in keys])
            if softcap:
                s = np.tanh(s / softcap) * softcap
            m = s.max()
            out[b, h] = m + np.log(np.exp(s - m).sum())
    return out


@pytest.mark.parametrize("D, Dv, Hq, Hkv, softcap, window", [
    (16, 16, 4, 1, 0.0, 0),
    (32, 32, 8, 2, 30.0, 0),
    (16, 16, 4, 4, 0.0, 5),
    (48, 32, 4, 1, 0.0, 0),
])
def test_plain_decode_lse_equals_its_closed_form(D, Dv, Hq, Hkv, softcap,
                                                 window):
    """``ref.decode_attention(..., return_lse=True)``: the output of the
    plain call as it is, each row's log-sum-exp within 2e-5 of the closed
    form, a row with no valid key 0 and NEG_INF; ``ops`` gives the same
    on the CPU."""
    g = torch.Generator().manual_seed(D + Hq + Hkv + window)
    B, S = 4, 24
    q = torch.randn(B, Hq, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, Dv, generator=g)
    clen = torch.tensor([0, 1, 17, 30], dtype=torch.int32)
    kw = dict(softcap=softcap, window=window)
    out, lse = ref.decode_attention(q, k, v, clen, return_lse=True, **kw)
    assert torch.equal(out, ref.decode_attention(q, k, v, clen, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq)
    want = _closed_form(q.numpy(), k.numpy(), v.numpy(), clen.numpy(),
                        softcap, window, D ** -0.5)
    assert np.all(lse[0].numpy() == np.float32(ref.NEG_INF))
    assert bool((out[0] == 0).all())
    err = np.abs(lse[1:].double().numpy() - want[1:])
    assert err.max() <= LSE_TOL * np.maximum(np.abs(want[1:]), 1.0).max()
    o2, lse2 = ops.decode_attention_lse(q, k, v, clen, **kw)
    assert torch.equal(o2, out) and torch.equal(lse2, lse)


def test_merge_partials_is_the_identity_on_one_rank():
    o = torch.randn(3, 4, 8)
    lse = torch.randn(3, 4)
    assert spmd.merge_partials(o, lse, None) is o

"""The MoE layer's sharded paths and the collectives on 4 gloo ranks on the
CPU, against the JAX package (``tests/test_distributed_small.py``'s
cases, whose JAX side runs 8 fake devices in a subprocess).

One spawn of 4 ranks runs ``torch_mesh_ranks.moe_paths`` and one runs
``torch_mesh_ranks.collectives``; the JAX oracles run here and reach the
ranks through ``.npz`` files.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcoll
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig, MoEConfig as JMoE

import torch_mesh_ranks as ranks

torch.set_num_threads(1)


def _cfg(E, cap, quant="none", shared=0, d_expert=32):
    return JConfig(
        name="t", family="moe", d_model=16, num_heads=1, num_kv_heads=1,
        vocab_size=8, compute_dtype="float32",
        moe=JMoE(num_experts=E, top_k=2, d_expert=d_expert,
                 capacity_factor=cap, dispatch_quant=quant,
                 num_shared_experts=shared,
                 d_shared_expert=32 if shared else 0))


CASES = {
    # 8 experts over a model axis of 2: expert parallel, with a shared
    # expert (d 32 over the axis: a partial sum)
    "ep": (_cfg(8, 8.0, shared=1), (4, 8)),
    # 5 experts do not divide the axis: every rank computes all of them on
    # its half of d_expert
    "tp": (_cfg(5, 5.0, shared=1), (4, 8)),
    "ep_int8": (_cfg(8, 8.0, quant="int8"), (4, 8)),
    "tp2d": (_cfg(8, 8.0, shared=1), (1, 4)),
}


def _flat(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_moe"))
    want = {}
    for name, (cfg, (B, T)) in CASES.items():
        p = jmoe.init_moe(jax.random.key(0), cfg)
        x = jax.random.normal(jax.random.key(1), (B, T, cfg.d_model))
        y, aux = jmoe._apply_moe_local(p, x, cfg)
        gx = jax.grad(lambda x: jnp.sum(
            jmoe._apply_moe_local(p, x, cfg)[0] ** 2))(x)
        want[name] = {"y": np.asarray(y), "aux": float(aux),
                      "gx": np.asarray(gx)}
        np.savez(os.path.join(tmp, f"moe_{name}.npz"), x=np.asarray(x),
                 **_flat(p))
        with open(os.path.join(tmp, f"moe_{name}.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
    rng = np.random.default_rng(0)
    coll = {"a2a_x": rng.normal(size=(4, 8, 3, 16)).astype(np.float32),
            "a2a_w": rng.normal(size=(4, 2, 12, 16)).astype(np.float32),
            "psum_x": rng.normal(size=(4, 8, 64)).astype(np.float32)}
    np.savez(os.path.join(tmp, "collectives.npz"), **coll)
    ranks.spawn("moe_paths", tmp, 4, deadline=240)
    ranks.spawn("collectives", tmp, 4, deadline=240)
    got = {"moe": ranks.load(tmp, "moe_paths"),
           "coll": [ranks.load(tmp, f"collectives_{r}") for r in range(4)]}
    return want, got, coll


@pytest.mark.parametrize("name", ["ep", "tp"])
def test_shardmap_moe_matches_the_local_oracle(moe_runs, name):
    """``_apply_moe_shardmap`` on (2, 2), tokens over data, experts (or
    each expert's d_expert) over model, capacity factor E so that no pair
    drops on the local or the global count: the output within 2e-4 of
    JAX's ``_apply_moe_local`` (``test_distributed_small.py:29-60``), the
    load-balancing loss over every rank's tokens within 1e-6, and the
    gradient with respect to the tokens within 2e-4."""
    want, got, _ = moe_runs
    w, g = want[name], got["moe"][name]
    assert float(np.abs(w["y"] - g["y"]).max()) < 2e-4
    assert abs(g["aux"] - w["aux"]) <= 1e-6 * abs(w["aux"])
    assert float(np.abs(w["gx"] - g["gx"]).max()) < 2e-4


def test_int8_dispatch_close_to_exact(moe_runs):
    """Expert parallel with the int8 all-to-all payload against the exact
    local oracle: within 0.03 relative (``test_distributed_small.py:
    102-139``), finite gradients."""
    want, got, _ = moe_runs
    w, g = want["ep_int8"], got["moe"]["ep_int8"]
    rel = float(np.abs(w["y"] - g["y"]).max() / np.abs(w["y"]).max())
    assert 0 < rel < 0.03, rel
    assert np.isfinite(g["gx"]).all()


def test_a2a_int8_against_the_plain_all_to_all(moe_runs):
    """``a2a_int8`` over a model axis of 4: each value within a per-row
    rounding step (max|row| / 254) of the plain all-to-all's, and the
    gradient exactly the plain all-to-all's (the backward is one)."""
    _, got, coll = moe_runs
    for r, out in enumerate(got["coll"]):
        a = out["a2a"]
        assert a["int8"].shape == (2, 12, 16)
        step = np.abs(a["plain"]).max(axis=-1, keepdims=True) / 254.0
        assert (np.abs(a["int8"] - a["plain"]) <= step * (1 + 1e-6)).all()
        assert np.array_equal(a["g_int8"], a["g_plain"])
        # the plain one is JAX's tiled all_to_all: rank r's split r
        want = np.concatenate([coll["a2a_x"][s][2 * r:2 * r + 2]
                               for s in range(4)], axis=1)
        assert np.array_equal(a["plain"], want)


def test_tp2d_moe_matches_local_under_serve2d(moe_runs):
    """serve2d rules on (2, 2): tokens replicated, d over data and
    d_expert over model, no weight moved: the output within 2e-4 of the
    local oracle (``test_distributed_small.py:141-169``)."""
    want, got, _ = moe_runs
    w, g = want["tp2d"], got["moe"]["tp2d"]
    assert float(np.abs(w["y"] - g["y"]).max()) < 2e-4
    assert abs(g["aux"] - w["aux"]) <= 1e-6 * abs(w["aux"])


def test_hierarchical_int8_cross_pod_psum(moe_runs):
    """``hierarchical_psum`` on (pod 2, data 2, model 1): the plain one is
    the sum over all 4 ranks; the int8 one is JAX's ``quantize_block``/
    ``dequantize_block`` of each pod's sum, summed over pods (within 1e-6
    of its largest), and within 0.02 of the exact sum."""
    _, got, coll = moe_runs
    x = coll["psum_x"]
    exact = x.sum(axis=0)
    pods = [x[0] + x[1], x[2] + x[3]]
    jax_int8 = sum(np.asarray(jcoll.dequantize_block(
        *jcoll.quantize_block(jnp.asarray(p)), p.shape)) for p in pods)
    for out in got["coll"]:
        ps = out["psum"]
        np.testing.assert_allclose(ps["plain"], exact, rtol=0,
                                   atol=1e-6 * np.abs(exact).max())
        np.testing.assert_allclose(ps["int8"], jax_int8, rtol=0,
                                   atol=1e-6 * np.abs(jax_int8).max())
        rel = np.abs(ps["int8"] - exact).max() / np.abs(exact).max()
        assert rel < 0.02, rel


@pytest.mark.parametrize("shape", [(5, 3), (256,), (2, 300)])
def test_quantize_block_matches_jax(shape):
    """``quantize_block``/``dequantize_block`` against JAX's: payloads and
    scales equal, a ragged last block, a zero block at the 1e-12 floor."""
    from repro_torch.distributed import collectives as tcoll

    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    if x.size > 256:
        x.reshape(-1)[:256] = 0.0
    jq, js = jcoll.quantize_block(jnp.asarray(x))
    tq, ts = tcoll.quantize_block(torch.tensor(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    back = tcoll.dequantize_block(tq, ts, shape)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        jcoll.dequantize_block(jq, js, shape)), rtol=1e-6, atol=1e-12)

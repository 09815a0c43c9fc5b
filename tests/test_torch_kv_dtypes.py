"""Every paged ``kv_dtype``, in the port, against the JAX engine on the
CPU (reduced tinyllama and the full-attention MoE, fp32 or bf16).

- The names: "auto", "int8" and any other dtype ``jnp.dtype`` takes and
  PyTorch has (float32, bfloat16, float16, float8_e4m3fn, float64, the
  integers, bool, complex); a name that is no dtype raises ``TypeError``
  in both engines.
- The JAX engine allocates its pools in the named dtype and its first
  write turns every one but int8 into the compute dtype
  (``attention.py:_page_scatter``); the port's pools hold the compute
  dtype from the start (pinned here), and both count their bytes in the
  named dtype (64-bit types as JAX holds them with x64 off).
- So the greedy streams, the counters and the byte accounting equal the
  JAX engine's, byte for byte, for each dtype, under fp32 and bf16
  compute, speculative too.
- The dense slot plane takes "auto" only, in both packages, and a
  ``ServiceSpec`` carries the name through the router's builders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.configs import get_reduced_config as jax_reduced
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_numpy_tree
from repro_torch.serving.engine import KV_DTYPES, ServingEngine, kv_dtype_of

torch.set_num_threads(1)

COUNTERS = ("cow_copies", "kv_prefix_hits", "kv_prefix_misses",
            "preemptions", "decode_stalls", "pages_in_use", "spec_rounds",
            "spec_accepted", "kv_capacity_bytes", "kv_bytes_in_use",
            "kv_dtype")


def _cfgs(arch="tinyllama-1.1b", compute="float32"):
    jcfg = dataclasses.replace(jax_reduced(arch), compute_dtype=compute)
    if arch == "mixtral-8x7b":
        jcfg = dataclasses.replace(jcfg, attn_type="full", sliding_window=0)
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _params(jcfg, tcfg, seed=0):
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(seed)), seed)
    return (jax.tree.map(jnp.asarray, flat),
            from_numpy_tree(flat, tcfg, "cpu"))


def _serve(eng):
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, size=40)
    prompts = [base, np.concatenate([base[:35], rng.integers(0, 256, 20)]),
               rng.integers(0, 256, size=23)]
    for wave in (prompts[:1], prompts[1:]):
        for p in wave:
            eng.submit(p, max_new_tokens=8)
        eng.run_until_drained()
    assert not eng.failed
    return [r.generated for r in sorted(eng.completed.values(),
                                        key=lambda r: r.rid)]


def test_kv_dtype_names():
    _, tcfg = _cfgs()
    assert kv_dtype_of("auto", tcfg) is torch.float32
    for name in ("float32", "bfloat16", "float16", "float8_e4m3fn", "int8",
                 "float64", "float8_e5m2", "int32", "uint8", "bool"):
        assert str(jnp.dtype(name)) == name            # JAX takes it
        assert kv_dtype_of(name, tcfg) is getattr(torch, name)
        assert kv_dtype_of(getattr(torch, name), tcfg) is \
            getattr(torch, name)
    assert set(KV_DTYPES) >= {"float8_e4m3fnuz", "complex128", "uint64"}
    assert jnp.dtype("f2") == jnp.float16 and jnp.dtype("half") == \
        jnp.float16
    assert kv_dtype_of("f2", tcfg) is kv_dtype_of("half", tcfg) is \
        torch.float16
    for bad in ("float12", "U10"):
        with pytest.raises(TypeError):
            JaxEngine(jax_reduced("tinyllama-1.1b"), kv_dtype=bad,
                      max_slots=2, max_seq=32)
        with pytest.raises(TypeError, match="no dtype"):
            ServingEngine(tcfg, device="cpu", kv_dtype=bad, max_seq=32)


def test_jax_pools_turn_into_the_compute_dtype_the_ports_hold_it():
    """The JAX engine allocates float16 pools and its first write turns
    them into fp32 (``.astype(k.dtype)`` in ``_page_scatter``); the
    port's are fp32 from the start.  Both count float16's bytes."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    kw = dict(max_slots=2, max_seq=64, kv_dtype="float16")
    je = JaxEngine(jcfg, params=jp, **kw)
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw)
    assert je.kv.pools["attn"]["k"].dtype == jnp.float16
    assert te.kv.pools["attn"]["k"].dtype == torch.float32
    _serve(je), _serve(te)
    assert je.kv.pools["attn"]["k"].dtype == jnp.float32
    assert te.kv.pools["attn"]["k"].dtype == torch.float32
    assert je.stats()["kv_capacity_bytes"] == \
        te.stats()["kv_capacity_bytes"] == te.kv.capacity_bytes() == \
        te.kv.pools["attn"]["k"].numel() * 2 * 2


STREAMS = [("tinyllama-1.1b", "float32", "float32", None),
           ("tinyllama-1.1b", "float32", "bfloat16", None),
           ("tinyllama-1.1b", "float32", "float16", "draft"),
           ("tinyllama-1.1b", "float32", "float8_e4m3fn", None),
           ("tinyllama-1.1b", "float32", "float64", None),
           ("tinyllama-1.1b", "bfloat16", "float32", None),
           ("tinyllama-1.1b", "bfloat16", "float16", None),
           ("tinyllama-1.1b", "bfloat16", "float8_e4m3fn", "draft"),
           ("mixtral-8x7b", "float32", "float8_e4m3fn", "draft"),
           ("mixtral-8x7b", "float32", "float16", None),
           ("mixtral-8x7b", "bfloat16", "float8_e4m3fn", None)]


@pytest.mark.parametrize("arch, compute, kv, draft", STREAMS,
                         ids=[f"{a}-{c}-{k}-{d or 'plain'}"
                              for a, c, k, d in STREAMS])
def test_pool_dtypes_equal_jax_streams(arch, compute, kv, draft):
    jcfg, tcfg = _cfgs(arch, compute)
    jp, tp = _params(jcfg, tcfg, 3)
    kw = dict(max_slots=2, max_seq=64, page_size=16, prefill_chunk=16,
              kv_dtype=kv)
    jd, td = {}, {}
    if draft:
        djcfg = dataclasses.replace(jax_reduced("tinyllama-1.1b"),
                                    num_layers=1, compute_dtype=compute)
        dtcfg = ModelConfig.from_dict(djcfg.to_dict())
        djp, dtp = _params(djcfg, dtcfg, 4)
        jd = dict(draft_cfg=djcfg, draft_params=djp, spec_k_max=3)
        td = dict(draft_cfg=dtcfg, draft_params=dtp, spec_k_max=3)
    je = JaxEngine(jcfg, params=jp, **kw, **jd).warmup()
    te = ServingEngine(tcfg, params=tp, device="cpu", **kw, **td).warmup()
    assert te.kv_dtype is getattr(torch, kv)
    for stack in te.kv.pools.values():
        assert {leaf.dtype for leaf in stack.values()} == {tcfg.cdtype}
    assert _serve(te) == _serve(je)
    assert {str(leaf.dtype) for stack in je.kv.pools.values()
            for leaf in stack.values()} == {compute}
    js, ts = je.stats(), te.stats()
    for key in COUNTERS:
        assert ts[key] == js[key], key


ODD = ["float64", "uint64", "complex128", "bool", "float8_e5m2",
       "float8_e4m3fnuz"]


@pytest.mark.parametrize("kv", ODD)
def test_byte_accounting_of_other_dtypes_equals_jax(kv):
    """The page size "auto" picks and the bytes counted, in the MoE with a
    leading dense layer (two pool stacks): JAX counts a pool as
    allocated, a 64-bit dtype as the 32-bit one it holds."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    moe = dataclasses.replace(jcfg.moe, first_dense_layers=1,
                              first_dense_d_ff=64)
    jcfg = dataclasses.replace(jcfg, moe=moe)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    kw = dict(max_slots=2, max_seq=64, page_size="auto", kv_dtype=kv)
    je = JaxEngine(jcfg, **kw)
    te = ServingEngine(tcfg, device="cpu", **kw)
    assert te.kv.page_size == je.kv.page_size
    assert set(te.kv.pools) == {"attn", "attn_dense"}
    js, ts = je.stats(), te.stats()
    for key in ("kv_capacity_bytes", "kv_bytes_in_use", "kv_dtype"):
        assert ts[key] == js[key], key


def test_dense_slots_and_specs_carry_kv_dtype():
    from repro_torch.core.spec import ServiceSpec
    from repro_torch.serving.router import (fleet_service_spec,
                                            make_engine_builder)

    _, scfg = _cfgs("mamba2-2.7b")
    jscfg = jax_reduced("mamba2-2.7b")
    for name in ("float16", "int8"):
        with pytest.raises(ValueError, match="paged-data-plane knob"):
            JaxEngine(jscfg, kv_dtype=name)
        with pytest.raises(ValueError, match="paged-data-plane knob"):
            ServingEngine(scfg, device="cpu", kv_dtype=name)
    _, tcfg = _cfgs()
    spec = fleet_service_spec(tcfg, kv_dtype="float8_e4m3fn")
    again = ServiceSpec.from_json(spec.to_json())
    assert again.kv_dtype == "float8_e4m3fn"
    ex, _ = make_engine_builder(tcfg, max_slots=2, max_seq=32,
                                device="cpu", autostart=False,
                                kv_dtype=again.kv_dtype)(spec.workload,
                                                         None)
    assert ex.engine.kv_dtype is torch.float8_e4m3fn
    assert ex.engine.kv.pools["attn"]["k"].dtype == tcfg.cdtype

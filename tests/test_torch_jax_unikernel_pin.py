"""The JAX unikernel decode image rejects its own second step at fp32
compute; the port's image keeps stepping.

``repro.serving.router.make_unikernel_decode_builder`` freezes its image
over ``init_caches``' bf16 default.  At fp32 compute the step returns
fp32 caches (its cache write casts to the compute dtype), so feeding
them back, as a decode loop does, no longer matches the frozen argument
spec and the second dispatch raises ``IncompatibleWorkload``.  The
port's builder makes its caches in the compute dtype, so its image takes
its own outputs for as many steps as the cache holds.  The first token
is the same in both (one key in the cache, written at fp32).
``tests/test_torch_edge_system.py`` compares longer streams by building
the JAX image over fp32 caches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.models.model import build_model as jax_build
from repro.serving import router as jrouter
from repro_torch import core as tcore
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.models.weights import from_numpy_tree
from repro_torch.serving import router as trouter

torch.set_num_threads(1)


def test_jax_decode_image_rejects_its_second_step_at_fp32(exact_config):
    jcfg = exact_config("edge-stream-light")
    assert jcfg.compute_dtype == "float32"
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    jp = jax_build(jcfg).init(jax.random.key(0))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    max_seq = 16
    jw = jcore.Workload("d", jcore.WorkloadKind.DECODE, jcfg, batch=1)
    tw = tcore.Workload("d", tcore.WorkloadKind.DECODE, tcfg, batch=1)
    jex, _ = jrouter.make_unikernel_decode_builder(
        jcfg, jcore.ImageRegistry(), params=jp, max_seq=max_seq)(jw, None)
    jcaches = jax_build(jcfg).init_caches(1, max_seq)
    assert all(c.dtype == jnp.bfloat16 for c in jax.tree.leaves(jcaches))
    jtok, jcaches, jlen = jex.dispatch(
        jw, (jp, jnp.array([7], jnp.int32), jcaches,
             jnp.zeros((1,), jnp.int32)))
    assert all(c.dtype == jnp.float32 for c in jax.tree.leaves(jcaches))
    with pytest.raises(jcore.IncompatibleWorkload):
        jex.dispatch(jw, (jp, jtok, jcaches, jlen))

    tex, _ = trouter.make_unikernel_decode_builder(
        tcfg, tcore.ImageRegistry(), params=tp, max_seq=max_seq,
        device="cpu")(tw, None)
    tcaches = build_model(tcfg, "cpu").init_caches(1, max_seq,
                                                   torch.float32)
    ttok, tlen = torch.tensor([7], dtype=torch.int32), \
        torch.zeros((1,), dtype=torch.int32)
    stream = []
    for _ in range(max_seq):
        ttok, tcaches, tlen = tex.dispatch(tw, (tp, ttok, tcaches, tlen))
        stream.append(int(ttok[0]))
    assert stream[0] == int(jtok[0]) and int(tlen[0]) == max_seq

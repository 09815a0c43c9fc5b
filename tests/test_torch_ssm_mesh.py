"""The SSM families split over the model axis, as the JAX specs split them.

``launch.programs.lower_program``'s argument bytes a rank for reduced
mamba2-2.7b and zamba2-1.2b on a 2 x 2 ``("data", "model")`` mesh at
``decode_32k``, ``prefill_32k`` and ``train_4k`` equal the JAX program's
``compile().memory_analysis().argument_size_in_bytes``, to the byte: the
Mamba2 caches take JAX's shards (the SSM state over its heads, the conv
tail an even cut of its channels) and zamba2's attention caches their KV
heads' (JAX in a subprocess with 4 host devices, the port in another as
rank 0 of 4 over the fake backend, both at once).  The gated norm's form
that takes a row's mean of squares from outside, the groups a rank's
heads read, and the step's view of the mesh.  The gloo ranks' prefill,
decode and train steps run in ``tests/test_torch_mesh_train.py``'s spawn.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import programs
from repro_torch.models import layers, mamba2

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
SHAPES = ("decode_32k", "prefill_32k", "train_4k")

_JAX = """
    import json
    import jax
    from repro.configs import get_reduced_config
    from repro.launch import programs
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            ma = programs.lower_program(get_reduced_config(arch), shape,
                                        mesh).compile().memory_analysis()
            out[f"{arch}/{shape}"] = ma.argument_size_in_bytes
    print(json.dumps(out))
"""

_PORT = """
    import json
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_test_mesh(2, 2, device="cpu")
    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            seen = programs.lower_program(get_reduced_config(arch), shape,
                                          mesh)
            out[f"{arch}/{shape}"] = seen.memory()["argument_bytes"]
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def both():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    head = f"ARCHS = {ARCHS!r}\nSHAPES = {SHAPES!r}\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", head + textwrap.dedent(body)],
        env=dict(env, **extra), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for body, extra in (
            (_JAX, {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                    "JAX_PLATFORMS": "cpu"}),
            (_PORT, {}))]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_argument_bytes_a_rank_equal_jax(both, arch, shape):
    jax_out, port_out = both
    key = f"{arch}/{shape}"
    assert port_out[key] == jax_out[key], (key, port_out[key], jax_out[key])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_with_the_rows_mean_square_from_outside(dtype):
    """A row cut in two halves, each normalized by the mean of squares of
    the whole row given from outside (``ms``), equals the whole row's
    ``rms_norm_simple`` forward, and its gradients (x, scale) equal the
    whole row's, the statistic differentiated through ``ms``; ``ops``
    takes the same form on the CPU."""
    g = torch.Generator().manual_seed(3)
    rows, d = 6, 64
    x = (torch.randn(rows, d, generator=g) * 2).to(dtype).requires_grad_()
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(dtype).requires_grad_()
    w = torch.randn(rows, d, generator=g).to(dtype)
    want = layers.rms_norm_simple(x, scale, 1e-5)
    gx, gs = torch.autograd.grad((want.float() * w.float()).sum(),
                                 [x, scale])
    x2 = x.detach().clone().requires_grad_()
    s2 = scale.detach().clone().requires_grad_()
    halves = x2.split(d // 2, dim=-1)
    ms = sum(torch.sum(torch.square(h.float()), dim=-1) for h in halves) / d
    got = torch.cat([layers.rms_norm_simple(h, s, 1e-5, ms=ms) for h, s in
                     zip(halves, s2.split(d // 2))], dim=-1)
    tol = 0 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol or 1e-6)
    hx, hs = torch.autograd.grad((got.float() * w.float()).sum(), [x2, s2])
    torch.testing.assert_close(hx, gx, rtol=tol or 1e-5, atol=tol or 1e-5)
    torch.testing.assert_close(hs, gs, rtol=tol or 1e-5, atol=tol or 1e-5)
    with torch.no_grad():
        h0 = halves[0].detach()
        assert torch.equal(
            ops.rmsnorm(h0, scale[:d // 2].detach(), eps=1e-5, ms=ms),
            ref.rmsnorm(h0, scale[:d // 2].detach(), 1e-5, ms))
        assert torch.equal(ref.rmsnorm(x.detach(), scale.detach(), 1e-5),
                           ref.rmsnorm(x.detach(), scale.detach(), 1e-5,
                                       torch.mean(torch.square(
                                           x.detach().float()), dim=-1)))


def test_groups_a_ranks_heads_read():
    """Whole groups when a rank's heads cover them, the one group they sit
    in, one group a head otherwise; the registered configs' single group
    on every rank."""
    base = get_reduced_config("mamba2-2.7b")          # 16 heads of 16

    def cfg(groups):
        return dataclasses.replace(base, ssm=dataclasses.replace(
            base.ssm, n_groups=groups))

    assert [mamba2.local_groups(cfg(1), 2, r) for r in range(2)] == [[0], [0]]
    assert [mamba2.local_groups(cfg(4), 2, r) for r in range(2)] == \
        [[0, 1], [2, 3]]
    assert mamba2.local_groups(cfg(2), 4, 3) == [1]
    # 12 heads in groups of 4, 6 a rank: rank 1's heads 6-11 read groups
    # 1 and 2, one group a head
    odd = dataclasses.replace(cfg(3), d_model=96)
    assert odd.ssm_heads == 12
    assert mamba2.local_groups(odd, 2, 1) == [1, 1, 2, 2, 2, 2]


def test_the_step_gathers_over_every_axis_but_model():
    """No family runs replicated over ``model``: a step gathers its
    parameters over the data axes only."""

    class Comm:
        names = ("pod", "data", "model")

    assert programs.view_axes(Comm()) == ("pod", "data")

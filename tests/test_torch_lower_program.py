"""``launch.programs.lower_program`` against the JAX package's.

Reduced tinyllama-1.1b and mixtral-8x7b on a 2 x 2 ``("data", "model")``
mesh, at ``decode_32k`` and ``train_4k``: the port's arguments a rank
(its shards of the parameters, the optimizer state or the caches, and the
batch) take the bytes the JAX program's
``compile().memory_analysis().argument_size_in_bytes`` gives, to the
byte.  JAX runs in a subprocess with 4 host devices, the port in another
as rank 0 of 4 over the fake backend (this process keeps no process
group), both at once.  The same subprocess counts a train step on a
data-parallel (4, 1) mesh against one rank: a rank's FLOPs times 4 are
the one rank's.  On the 1 x 1 mesh no collective is recorded.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.launch import programs
from repro_torch.launch.mesh import LocalMesh
from repro_torch.launch.shapes import ShapeSpec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("tinyllama-1.1b", "mixtral-8x7b")
SHAPES = ("decode_32k", "train_4k")
DP_SHAPE = ShapeSpec("dp", 64, 8, "train")

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
    from repro_torch.launch.mesh import LocalMesh, make_test_mesh
    from repro_torch.launch.shapes import ShapeSpec
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_test_mesh(2, 2, device="cpu")
    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            seen = programs.lower_program(get_reduced_config(arch), shape,
                                          mesh)
            out[f"{arch}/{shape}"] = seen.memory()["argument_bytes"]
    cfg = get_reduced_config("tinyllama-1.1b")
    shape = ShapeSpec("dp", 64, 8, "train")
    dp = programs.lower_program(cfg, shape, make_test_mesh(4, 1,
                                                           device="cpu"))
    one = programs.lower_program(cfg, shape, LocalMesh("meta"))
    out["dp"] = [dp.cost()["flops"], one.cost()["flops"],
                 dp.cost()["collectives"].count]
    print(json.dumps(out))
"""


def _script(body: str) -> str:
    return (f"ARCHS = {ARCHS!r}\nSHAPES = {SHAPES!r}\n"
            + textwrap.dedent(body))


@pytest.fixture(scope="module")
def both():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _script(body)], env=dict(env, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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


def test_data_parallel_flops_scale_with_the_ranks(both):
    dp, one, counts = both[1]["dp"]
    assert dp > 0 and dp * 4 == one
    # the fsdp gathers and the gradient all-reduce over data
    assert counts.get("all-gather", 0) > 0 and counts.get("all-reduce", 0) > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", DP_SHAPE])
def test_one_rank_mesh_records_no_collective(shape):
    seen = programs.lower_program(get_reduced_config("tinyllama-1.1b"),
                                  shape, LocalMesh("meta"))
    c = seen.cost()["collectives"]
    assert c.count == {} and c.wire_bytes == 0.0
    assert seen.cost()["flops"] > 0 and seen.memory()["argument_bytes"] > 0

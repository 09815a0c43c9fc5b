"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, the port runs with JAX
made unimportable, and its entry points refuse a missing GPU instead of
falling back to the CPU."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

torch.set_num_threads(1)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_imports():
    files = _port_files()
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_port_runs_with_jax_unimportable(tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["repro"] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        import repro_torch.launch.serve
        import repro_torch.launch.train
        import repro_torch.launch.mesh, repro_torch.launch.shapes
        import repro_torch.launch.programs
        import repro_torch.distributed.sharding, repro_torch.distributed.spmd
        import repro_torch.distributed.collectives
        import repro_torch.distributed.fault_tolerance
        from repro_torch.configs import get_config
        from repro_torch.distributed import collectives
        from repro_torch.launch import programs
        class ShapeOnly:                   # a mesh that is only its shape
            shape = {"data": 16, "model": 16}
        specs = programs.program_shardings(get_config("nemotron-4-340b"),
                                           "train_4k", ShapeOnly())[0]
        assert specs[0]["embed"]["embedding"] == ("model", "data")
        q, s = collectives.quantize_block(torch.ones(300))
        assert q.dtype == torch.int8 and s.shape == (2, 1)
        import repro_torch.kernels.build
        import repro_torch.core
        import repro_torch.serving.router
        from repro_torch.configs import get_reduced_config
        from repro_torch.serving.engine import ServingEngine
        eng = ServingEngine(get_reduced_config("tinyllama-1.1b"),
                            max_slots=2, max_seq=32, device="cpu")
        logits = eng.model.forward(eng.params,
                                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})
        assert logits.shape == (1, 4, 256) and torch.isfinite(logits).all()
        r = eng.submit(np.arange(6), max_new_tokens=3).result(timeout=60)
        assert len(r.generated) == 3
        import repro_torch.models.moe
        moe_eng = ServingEngine(get_reduced_config("mixtral-8x7b"),
                                max_slots=2, max_seq=64, device="cpu")
        r = moe_eng.submit(np.arange(40), max_new_tokens=2).result(timeout=60)
        assert len(r.generated) == 2
        import repro_torch.configs.deepseek_v2_236b
        mla_eng = ServingEngine(get_reduced_config("deepseek-v2-236b"),
                                max_slots=2, max_seq=64, device="cpu")
        r = mla_eng.submit(np.arange(20), max_new_tokens=2).result(timeout=60)
        assert len(r.generated) == 2
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import EdgeSystem, ImageRegistry, NodeCapacity
    from repro_torch.data import stream
    from repro_torch.launch import serve, train
    from repro_torch.serving import router
    from repro_torch.models.attention import init_paged_pool
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import init_paged_cache_tree
    from repro_torch.models.weights import from_numpy_tree
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagedKVCache, SlotKVCache
    from repro_torch.train.trainer import Trainer

    cfg = get_reduced_config("tinyllama-1.1b")
    ssm = get_reduced_config("mamba2-2.7b")
    for make in (lambda: Model(cfg),
                 lambda: Model(cfg, device="cuda"),
                 lambda: ServingEngine(cfg),
                 lambda: ServingEngine(cfg, device="cuda:0"),
                 lambda: PagedKVCache(cfg, max_slots=2, max_seq=64),
                 lambda: SlotKVCache(ssm, max_slots=2, max_seq=64),
                 lambda: ServingEngine(ssm),
                 lambda: Model(get_reduced_config("zamba2-1.2b")),
                 lambda: Model(get_reduced_config("mixtral-8x7b")),
                 lambda: Model(get_reduced_config("deepseek-v2-236b")),
                 lambda: serve.main(["--arch", "mamba2-2.7b", "--reduced",
                                     "--requests", "1"]),
                 lambda: init_paged_cache_tree(cfg, 3, 16),
                 lambda: init_paged_pool(cfg, 3, 16),
                 lambda: from_numpy_tree({}, cfg),
                 lambda: serve.main(["--reduced", "--requests", "1"]),
                 lambda: Trainer(cfg),
                 lambda: Trainer(cfg, device="cuda"),
                 lambda: Trainer(cfg, "cuda"),
                 lambda: train.main(["--reduced", "--steps", "1"]),
                 # the control plane: builders, nodes and launch/serve.py
                 lambda: router.make_container_builder(cfg),
                 lambda: router.make_unikernel_decode_builder(
                     get_reduced_config("edge-stream-light"),
                     ImageRegistry()),
                 lambda: router.make_stream_builder(ImageRegistry(),
                                                    stream.StreamConfig()),
                 lambda: router.make_stream_container_builder(
                     stream.StreamConfig()),
                 lambda: router.make_engine_builder(cfg),
                 lambda: router.assemble_edge_system(EdgeSystem(), cfg),
                 lambda: EdgeSystem().add_node("n0"),
                 lambda: EdgeSystem().add_node("n0", mesh="cuda:0"),
                 lambda: NodeCapacity(),
                 lambda: stream.init_state(stream.StreamConfig()),
                 lambda: serve.main(["--reduced", "--requests", "1",
                                     "--save-state", "/nonexistent/s"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # a CPU node has no card to read: it must be given its capacity
    with pytest.raises(ValueError, match="capacity"):
        EdgeSystem().add_node("n0", mesh="cpu")

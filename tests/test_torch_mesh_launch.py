"""The port's launcher under torchrun with 2 gloo ranks on the CPU, and a
sharded ``ExecutableImage`` on 2 ranks.

``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
repro_torch.launch.train --device cpu --mesh test --distributed`` trains
reduced tinyllama on the (2, 1) mesh, each rank reading its own rows of
the stream; 3 steps and a restart for one more end on the loss of 4
steps that did not stop.  ``--mesh single`` at world size 2 exits
non-zero naming the world size it needs.  Each launch takes about 10 s.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from repro.configs import get_reduced_config as jreduced
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.models.config import ModelConfig
from repro_torch.tree import flatten_with_path

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torchrun(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        # niced as torch_mesh_ranks' ranks are
        ["nice", "-n", "10", sys.executable, "-m", "torch.distributed.run",
         "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--reduced", "--device", "cpu", "--distributed", "--batch", "4",
         "--seq", "16", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def _losses(out: str):
    return [float(x) for x in re.findall(r"loss=([0-9.]+)", out)]


def test_launcher_restarts_exactly_under_torchrun(tmp_path):
    whole = _torchrun("--steps", "4", "--ckpt-dir", str(tmp_path / "a"))
    assert whole.returncode == 0, whole.stderr[-3000:]
    first = _torchrun("--steps", "3", "--ckpt-dir", str(tmp_path / "b"))
    assert first.returncode == 0, first.stderr[-3000:]
    again = _torchrun("--steps", "1", "--ckpt-dir", str(tmp_path / "b"))
    assert again.returncode == 0, again.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 1}" in whole.stdout
    final = [float(x) for x in re.findall(r"final loss ([0-9.]+)",
                                          whole.stdout + again.stdout)]
    assert len(final) == 4 and final[0] == final[1] == final[2] == final[3]
    # the restarted run's parameters are the unbroken run's, bit for bit
    (a, _), (b, _) = (ck.restore(str(tmp_path / d), 4) for d in "ab")
    want, got = dict(flatten_with_path(a)), dict(flatten_with_path(b))
    assert sorted(want) == sorted(got)
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_production_mesh_refuses_the_wrong_world_size(tmp_path):
    r = _torchrun("--mesh", "single", "--steps", "1", "--ckpt-dir",
                  str(tmp_path))
    assert r.returncode != 0
    assert "world size 256" in r.stderr and "world size 2" in r.stderr


def test_sharded_decode_image_on_two_ranks(tmp_path):
    """A decode step built as an ``ExecutableImage`` with ``in_shardings``
    on (2, 1): each rank's arguments are its shards (its batch rows and
    cache rows, half of every fsdp dim of the parameters), and a call
    gives the eager whole step's rows."""
    cfg = ModelConfig.from_dict(dataclasses.replace(
        jreduced("tinyllama-1.1b"), compute_dtype="float32").to_dict())
    with open(tmp_path / "image_cfg.json", "w") as f:
        json.dump(cfg.to_dict(), f)
    ranks.spawn("sharded_image", str(tmp_path), 2, deadline=180)
    for r in range(2):
        out = ranks.load(str(tmp_path), f"image_{r}")
        assert out["param_shape"] == (256, 64) and \
            out["param_whole"] == (256, 128)
        assert out["logits"].shape == (2, 256)
        np.testing.assert_allclose(out["logits"], out["want"], rtol=0,
                                   atol=1e-5 * np.abs(out["want"]).max())
        np.testing.assert_allclose(out["k"], out["k_want"], rtol=0,
                                   atol=1e-5)
        assert np.array_equal(out["len"], out["len_want"])

"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``) and
sweep (``launch/sweep.py``) on the CPU, each cell in a process of its own
as rank 0 of the production mesh's world (256 ranks for ``single``, 512
for ``multi``) over the fake backend, its step run on ``meta``.

The cells, at once: tinyllama-1.1b ``decode_32k`` on the 2 x 16 x 16 mesh
(the JAX dry-run test's own cell, ``tests/test_distributed_small.py``:
its 4 KV heads do not divide the model axis of 16, so its caches split
along the sequence), and at reduced width deepseek-v2-236b ``decode_32k``
on 16 x 16 (moe, MLA's latent cache) and zamba2-1.2b ``train_4k`` on
2 x 16 x 16 (hybrid).  Each ends ok with a record whose ``memory`` and
``roofline`` keys are JAX's; a cell that fails inside is recorded and
exits 1; a cell that does not apply is skipped.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.roofline import analysis as janalysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {
    "tinyllama": ["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                  "--mesh", "multi"],
    "deepseek": ["--arch", "deepseek-v2-236b", "--shape", "decode_32k",
                 "--mesh", "single", "--reduced"],
    "zamba2": ["--arch", "zamba2-1.2b", "--shape", "train_4k", "--mesh",
               "multi", "--reduced"],
    # 16 rows a rank do not split into 3 microbatches: fails inside
    "fails": ["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh",
              "single", "--reduced", "--microbatch", "3"],
    "skips": ["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--mesh",
              "single", "--reduced"],
}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for name, args in CELLS.items():
        out = str(tmp / f"{name}.json")
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", out], env=_env(), cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    done = {}
    try:
        for name, (out, p) in procs.items():
            log, _ = p.communicate(timeout=240)
            with open(out) as f:
                done[name] = (p.returncode, log, json.load(f))
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
    return done


@pytest.mark.parametrize("name, chips", [("tinyllama", 512),
                                         ("deepseek", 256), ("zamba2", 512)])
def test_cells_end_ok_with_jax_record_keys(cells, name, chips):
    rc, log, rec = cells[name]
    assert rc == 0, log[-3000:]
    assert rec["ok"] and rec["chips"] == chips, rec.get("error")
    assert "OK lower=" in log and "roofline(s): compute=" in log
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    fields = {f.name for f in dataclasses.fields(janalysis.Roofline)}
    assert set(rec["roofline"]) == fields
    assert set(rec["roofline"]["collective"]) == {
        f.name for f in dataclasses.fields(janalysis.CollectiveStats)}
    assert "fit" not in rec
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_fused_per_device"] > 0
    assert r["collective"]["wire_bytes"] > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_split_cache_decode_counts_the_log_sum_exp_kernel(cells):
    """tinyllama's decode on the multi-pod mesh runs the split-cache path:
    the log-sum-exp decode once a layer, no plain decode call."""
    rec = cells["tinyllama"][2]
    assert rec["kernels"]["decode_attention_lse"]["calls"] == 22
    assert "decode_attention" not in rec["kernels"]
    assert rec["roofline"]["collective"]["count"]["all-reduce"] > 0


def test_a_failed_cell_is_recorded_and_exits_1(cells):
    rc, log, rec = cells["fails"]
    assert rc == 1 and not rec["ok"]
    assert "microbatches" in rec["error"] and "FAIL" in log
    assert rec["traceback"]


def test_a_cell_that_does_not_apply_is_skipped(cells):
    rc, _, rec = cells["skips"]
    assert rc == 0 and rec["ok"] and "sub-quadratic" in rec["skipped"]


def test_sweep_runs_a_cell_and_writes_its_artifact(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--mesh",
         "single", "--arch", "mixtral-8x7b", "--shape", "prefill_32k",
         "--reduced"], env=_env(), cwd=tmp_path, capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    art = tmp_path / "build" / "port_dryrun" / \
        "mixtral-8x7b.reduced.prefill_32k.16x16.json"
    rec = json.loads(art.read_text())
    assert rec["ok"] and rec["chips"] == 256 and rec["kind"] == "prefill"
    assert "[sweep] done ok=1 fail=0" in r.stdout

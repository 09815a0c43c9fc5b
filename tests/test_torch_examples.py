"""The port's five examples (``examples/torch_*.py``) on the CPU, each in a
subprocess where JAX and the JAX package cannot be imported (a
``sitecustomize`` on the path blocks them, in spawned ranks too), each
run with ``--device cpu`` and one thread: the stream analytics' per-batch
outputs against the JAX example's, the training example killed and rerun
against its unbroken run, the elastic restart's resharding restore, the
hybrid scenario's routes and failover against the JAX example's lines,
and the quickstart's served requests."""
import json
import os
import re
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

torch.set_num_threads(1)

BLOCKER = """
import sys
for _name in ("jax", "jaxlib", "flax", "repro"):
    sys.modules[_name] = None
"""


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    blocker = tmp_path_factory.mktemp("blocker")
    (blocker / "sitecustomize.py").write_text(BLOCKER)
    return dict(os.environ, PYTHONPATH=f"{blocker}{os.pathsep}{ROOT / 'src'}",
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")


def _run(env, args, cwd, timeout=120):
    out = subprocess.run([sys.executable] + [str(a) for a in args],
                         capture_output=True, text=True, env=env, cwd=cwd,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def _example(name, env, tmp_path, *flags, timeout=120):
    return _run(env, [EXAMPLES / f"{name}.py", "--device", "cpu", *flags],
                tmp_path, timeout)


def _run_jax_example(name, capsys):
    """A JAX example's ``main`` in this process; its printed lines."""
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _record_submits(system_cls, outs):
    orig = system_cls.submit

    def submit(self, workload, args=()):
        res = orig(self, workload, args)
        outs.append({k: np.asarray(v).tolist()
                     for k, v in res.output[1].items()})
        return res
    return orig, submit


def test_the_blocker_blocks(env, tmp_path):
    code = ("import importlib\n"
            "for m in ('jax', 'repro'):\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "    except ImportError:\n"
            "        continue\n"
            "    raise SystemExit(m + ' imported')\n")
    _run(env, ["-c", code], tmp_path)


def test_stream_analytics_matches_the_jax_example(env, tmp_path, capsys):
    """Every batch's outputs (the per-user averages, their maximum and its
    user) within 2e-5 of the JAX example's: the record stream is made with
    numpy from the same seed in both packages."""
    code = textwrap.dedent(f"""
        import json, runpy, sys
        import numpy as np
        from repro_torch.core.system import EdgeSystem
        outs = []
        orig = EdgeSystem.submit
        def submit(self, workload, args=()):
            res = orig(self, workload, args)
            outs.append({{k: v.cpu().numpy().tolist()
                         for k, v in res.output[1].items()}})
            return res
        EdgeSystem.submit = submit
        sys.argv = ["torch_stream_analytics.py", "--device", "cpu"]
        runpy.run_path({str(EXAMPLES / 'torch_stream_analytics.py')!r},
                       run_name="__main__")
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        json.dump(outs, open("outs.json", "w"))
    """)
    printed = _run(env, ["-c", code], tmp_path)
    got = json.loads((tmp_path / "outs.json").read_text())

    from repro.core.system import EdgeSystem as JaxSystem
    want = []
    orig, submit = _record_submits(JaxSystem, want)
    JaxSystem.submit = submit
    try:
        jax_printed = _run_jax_example("stream_analytics", capsys)
    finally:
        JaxSystem.submit = orig
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=2e-5, atol=0)
    # the same batch lines, up to their timings
    def batches(text):
        return [re.sub(r"\[.*\]", "", line) for line in text.splitlines()
                if line.startswith("batch ")]
    assert batches(printed) == batches(jax_printed)
    assert "registry {'builds': 1, 'hits': 1, 'images': 1}" in printed


def _losses(text):
    """``{step: "loss=... lr=..."}`` of a training log."""
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^step\s+(\d+) (loss=\S+ lr=\S+)", text, re.M)}


def test_edge_train_killed_and_rerun_resumes_at_its_checkpoint(env,
                                                               tmp_path):
    """Killed after its step-30 log line (the step-20 checkpoint is
    committed, no later one), the rerun on the same directory resumes from
    step 20 and logs the losses of the unbroken run."""
    unbroken = _example("torch_edge_train", env, tmp_path, "--steps", "60",
                        "--ckpt-dir", tmp_path / "unbroken")
    ckpt = tmp_path / "killed"
    proc = subprocess.Popen(
        [sys.executable, str(EXAMPLES / "torch_edge_train.py"), "--device",
         "cpu", "--steps", "60", "--ckpt-dir", str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=tmp_path)
    try:
        for line in proc.stdout:
            if line.startswith("step   30"):
                break
        proc.kill()
    finally:
        proc.kill()
        proc.wait(30)
    assert (ckpt / "step_000000020.COMMIT").exists()
    rerun = _example("torch_edge_train", env, tmp_path, "--steps", "40",
                     "--ckpt-dir", ckpt)
    assert "resumed from step 20" in rerun
    want, got = _losses(unbroken), _losses(rerun)
    assert sorted(got) == [30, 40, 50, 60]
    assert got == {s: want[s] for s in got}
    assert "tokens/s on cpu" in rerun


def test_elastic_restart_restores_the_phase_1_step(env, tmp_path):
    """Phase 1 on 4 gloo ranks (a 2 x 2 mesh), the failure detector's and
    the plan's lines as the JAX example prints them, and phase 2 on the
    planned (1 x 2) mesh restored at phase 1's step."""
    from repro.distributed.fault_tolerance import plan_elastic_mesh

    out = _example("torch_elastic_restart", env, tmp_path, "--ckpt-dir",
                   tmp_path / "ckpt", "--deadline", "100")
    lines = out.splitlines()
    assert re.fullmatch(r"phase 1 \(2×2 mesh\): step=20 loss \S+ -> \S+",
                        lines[0])
    assert lines[1] == ("failure detector: ['h1'] failed "
                        "(healthy: ['h0', 'h2', 'h3'])")
    plan = plan_elastic_mesh(total_hosts=4, failed_hosts=1,
                             chips_per_host=1, base_mesh=(2, 2))
    assert lines[2] == (f"elastic plan: {plan.note}; new mesh = "
                        f"({plan.data_axis}×{plan.model_axis}), batch scale "
                        f"×{plan.global_batch_scale}")
    assert re.fullmatch(r"phase 2 \(1×2 mesh, batch 8->4\): step=35 "
                        r"loss \S+ -> \S+", lines[3])
    assert lines[4].startswith("elastic restart complete")
    assert (tmp_path / "ckpt" / "step_000000035.COMMIT").exists()


def test_elastic_restart_refuses_a_non_empty_ckpt_dir(env, tmp_path):
    """A ``--ckpt-dir`` that holds anything is refused before a rank
    starts, and what it holds is left as it was."""
    ckpt = tmp_path / "run"
    ckpt.mkdir()
    (ckpt / "keep.txt").write_text("an earlier run")
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_elastic_restart.py"),
         "--device", "cpu", "--ckpt-dir", str(ckpt)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=60)
    assert out.returncode != 0
    assert "is not empty" in out.stderr
    assert [p.name for p in ckpt.iterdir()] == ["keep.txt"]
    assert (ckpt / "keep.txt").read_text() == "an earlier run"


def test_hybrid_edge_serving_routes_and_redeploys_as_jax(env, tmp_path,
                                                         capsys):
    """Every frame on a CV container, every record batch on a stream
    image, the failed node's instance redeployed and the stream service
    scaled to 3: the JAX example's lines, up to timings and the
    report's numbers."""
    got = _example("torch_hybrid_edge_serving", env, tmp_path)
    want = _run_jax_example("hybrid_edge_serving", capsys)

    def shape(text):
        return [re.sub(r" \([\d.]+ ms\)$", "", line)
                for line in text.splitlines()
                if not line.startswith(("heavy:", "light:"))]
    assert shape(got) == shape(want)
    frames = [line for line in got.splitlines() if line.startswith("[frame")]
    sensors = [line for line in got.splitlines()
               if line.startswith("[sensor")]
    assert len(frames) == len(sensors) == 6
    assert all(" heavy on " in f and "via container[" in f for f in frames)
    assert all(" light on " in s and "via unikernel[" in s for s in sensors)
    victim = re.search(r"!! node (\S+) failed -> redeployed "
                       r"\['stream-analytics/0'\]", got).group(1)
    assert not [s for s in sensors[3:] if f" on {victim} " in s]
    assert "services: {'cv-infer': 2, 'stream-analytics': 3}" in got


def test_quickstart_serves_every_request(env, tmp_path):
    """Twenty training steps, then both prompts served through the
    engine's container with eight tokens each; the model is the JAX
    quickstart's (four heads of 16), whose ``arch=... params=...`` line
    it prints."""
    import importlib.util

    from repro.configs import get_reduced_config

    out = _example("torch_quickstart", env, tmp_path)
    jax_cfg = get_reduced_config("tinyllama-1.1b", num_layers=2, d_model=64,
                                 head_dim=16, d_ff=128, vocab_size=128)
    assert (jax_cfg.num_heads, jax_cfg.num_kv_heads, jax_cfg.head_dim) == \
        (4, 4, 16)
    assert out.splitlines()[0] == (f"arch={jax_cfg.name} "
                                   f"params={jax_cfg.num_params():,}")
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", EXAMPLES / "torch_quickstart.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.model_config().to_dict() == jax_cfg.to_dict()
    first, last = map(float, re.search(r"loss: (\S+) -> (\S+)",
                                       out).groups())
    assert last < first
    served = re.findall(r"request (\d+) on edge0: generated \[(.*)\]", out)
    assert [rid for rid, _ in served] == ["0", "1"]
    assert all(len(toks.split(",")) == 8 for _, toks in served)
    assert re.search(r"served: 2 requests", out)
    assert not list(tmp_path.iterdir())        # no checkpoint left behind

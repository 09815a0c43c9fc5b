"""Whole runs of each cell on the CPU at reduced widths, through the same
deployment, loops, metrics and check as on the card (the kernels' plain
versions stand in for the CUDA ones): what is served agrees with the
plain reference; a fault planted in the timed path makes ``correct``
false; the fp8 control reads a wider gap than the program; a
configuration, a traffic mix and a metric added as files only are found
by name; nothing imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from benchlib import cell as cell_mod  # noqa: E402
from benchlib import check  # noqa: E402
from benchlib.spec import Cell  # noqa: E402

CELLS = ["nemotron-4-340b.chat", "chameleon-34b.camera-vqa",
         "nemotron-4-340b.docqa"]
SEED = 2 ** 31 + 101
# reduced widths for the CPU; the layer kinds, norms, activations and
# qk-norm stay the configurations' own
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512)


def tiny(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    c = Cell(name, root, here)
    c.config["model"].update(TINY)
    c.config["engine"].update(max_slots=8, max_seq=256, num_pages=8 * 16 + 1,
                              prefill_chunk=64, prefill_budget=64)
    if "image" in c.config["vocab"]:
        c.config["vocab"] = {"text": [102, 512], "image": [4, 100],
                             "begin_image": 101, "end_image": 100}
    else:
        c.config["vocab"] = {"text": [0, 512]}
    t = c.traffic
    t.update(lead_s=0.5, drain_s=30, check_tokens=48, check_requests=2)
    if t["generator"] == "open_loop":
        t["rate_rps"] = 4
        t["output"] = {"median": 8, "sigma": 0.5, "min": 2, "max": 24}
        if "docs" in t:
            t["docs"].update(count=4, min=100, max=180)
            t["prompt"] = {"min": 4, "max": 8}
        else:
            t["prompt"] = {"median": 40, "sigma": 0.5, "min": 8, "max": 120}
    else:
        t.update(clients=4, header=16, image={"tokens": 32}, stagger_s=0.3,
                 question={"min": 4, "max": 8}, turns={"min": 1, "max": 3},
                 answer={"median": 6, "sigma": 0.5, "min": 2, "max": 12},
                 pool=64)
    return c


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(c: Cell, seconds: float = 2.0, keep=None):
    return cell_mod.run(c, SEED, seconds, False, "cpu", time.monotonic(),
                        keep=keep)


@pytest.mark.parametrize("name", CELLS)
def test_cell_serves_what_the_reference_computes(name):
    keep: dict = {}
    res, checks = _run(tiny(name), keep=keep)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert {n for n, _, _ in checks} == set(res["check"])
    w = res["work"]
    assert w["chunks"] == w["chunks_run"]        # every chunk accounted for
    assert w["tokens"] > 0 and w["steps"] > 0
    picked = keep["picked"]
    assert picked and sum(len(g) for _, g in picked) >= 1
    e2e = {m["name"] for m in Cell(name).metrics(False)}
    assert set(res["metrics"]) == e2e - {"peak_mem_gib"}   # no card here


def _altered(engine_cls, monkeypatch):
    """Plant a fault where decode tokens are produced: every active row's
    token is moved by one id."""
    orig = engine_cls._decode

    def bad(self, tokens, cache_len, active, caches=None):
        nxt, new_len = orig(self, tokens, cache_len, active, caches)
        return torch.where(active, (nxt + 1) % self.cfg.vocab_size,
                           nxt).to(nxt.dtype), new_len
    monkeypatch.setattr(engine_cls, "_decode", bad)


def _first_altered(engine_cls, monkeypatch):
    """Plant a fault in the prefill's logits: the first token of every
    request is another one."""
    orig = engine_cls._chunk

    def bad(self, *a, **k):
        logits = orig(self, *a, **k)
        return torch.roll(logits, 1, dims=-1)
    monkeypatch.setattr(engine_cls, "_chunk", bad)


@pytest.mark.parametrize("fault", [_altered, _first_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_token_altered_where_produced_is_not_correct(name, fault,
                                                       monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    fault(ServingEngine, monkeypatch)
    res, checks = _run(tiny(name))
    assert not res["correct"]
    gap = dict((n, v) for n, v, _ in checks)["logit_gap"]
    assert gap > Cell(name).limits["limits"]["logit_gap"]


def test_control_reads_wider_than_the_program():
    """The fp8 control on the same prompts and served tokens reads a
    wider gap than the bf16 program (at a width where fp8's rounding
    shows: d_model 256 over a vocabulary of 4096)."""
    c = tiny("nemotron-4-340b.chat")
    c.config["model"].update(d_model=256, d_ff=512, vocab_size=4096,
                             num_heads=4, head_dim=64)
    c.config["vocab"] = {"text": [0, 4096]}
    keep: dict = {}
    res, _ = _run(c, keep=keep)
    program = res["check"]["logit_gap"]["value"]
    control = check.widest_gap(keep["ref"], keep["weights"], keep["model"],
                               keep["picked"], "cpu", control=True)
    assert control > max(3 * program, 1e-3)


def test_reference_loads_nothing_of_the_program():
    path = HERE / "reference" / "dense_decoder.py"
    code = ("import sys; sys.path.insert(0, %r); import runpy; "
            "runpy.run_path(%r); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')); "
            "print(bad); sys.exit(1 if bad else 0)") % (str(HERE), str(path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_import_guard():
    """No module of the benchmark imports JAX or the JAX package (by whole
    top-level name: ``repro_torch`` is another name), and the reference
    imports nothing of the program."""
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in (HERE / "reference").glob("*.py"):
        assert not (_imports(f) & (FORBIDDEN | {"repro_torch", "benchlib"}))
    assert cell_mod.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    sys.modules["jax_looking_name"] = sys.modules["os"]
    try:
        assert "jax_looking_name" not in cell_mod.forbidden_modules()
    finally:
        del sys.modules["jax_looking_name"]


def _copy(tmp: Path, with_src: bool) -> Path:
    root = tmp / "checkout"
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    if with_src:
        (root / "src").symlink_to(ROOT / "src")
    return root


def _run_py(root: Path, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *args],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    bare = _run_py(_copy(tmp_path / "bare", with_src=False))
    assert bare.returncode != 0 and not bare.stdout.strip()
    nocard = _run_py(_copy(tmp_path / "full", with_src=True))
    assert nocard.returncode != 0 and not nocard.stdout.strip()
    assert "CUDA" in nocard.stderr


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as files and entries only: the harness runs the new cell and reports
    the new metric."""
    root = _copy(tmp_path, with_src=False)
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "nemotron-4-340b.json").read_text())
    cfg["name"] = "tiny-decoder"
    (pb / "configs" / "tiny-decoder.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "chat.json").read_text())
    mix["why"] = "an added mix"
    (pb / "traffic" / "short-chat.json").write_text(json.dumps(mix))
    (pb / "cells" / "tiny-decoder.short-chat.json").write_text(
        json.dumps({"limits": {"logit_gap": 0.5}}))
    (pb / "metrics" / "decode_rows.online.py").write_text(
        '"""Decode row-steps in the window."""\n\n\n'
        'def read(win):\n    return float(win.work()["rows"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-decoder", "source": "x",
                             "file": "port_bench/configs/tiny-decoder.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-decoder.short-chat",
                               "config": "tiny-decoder",
                               "traffic": "short-chat", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_ms", "tpot_p95_ms"):
            m["workloads"].append("tiny-decoder.short-chat")
    bench["per_layer"].append({"name": "decode_rows.online", "unit": "rows",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine", "moves": "tpot_p95_ms",
                               "workloads": ["tiny-decoder.short-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = tiny("tiny-decoder.short-chat", root, pb)
    assert c.traffic["why"] == "an added mix"
    assert "decode_rows.online" in {m["name"] for m in c.metrics(True)}
    assert "tpot_p95_ms" in {m["name"] for m in c.metrics(False)}
    res, _ = cell_mod.run(c, SEED, 2.0, True, "cpu", time.monotonic())
    assert res["correct"], res["check"]
    assert res["metrics"]["decode_rows.online"]["value"] > 0
    assert res["metrics"]["decode_rows.online"]["unit"] == "rows"

"""The port's static analyzer (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): on the shared seeded fixtures of
``tests/test_analysis.py``, over ``src/repro`` and over
``src/repro_torch``, the LO, GB, BL, RT and CH families give the same
findings (id, rule, severity, line).  The KL family is the deliberate
difference: it lints the port's CUDA kernel wrappers (a public function
of ``kernels/`` that reaches ``build.load``), so it has fixtures of its
own.  Then the CLI, and the port's tree against
``analysis_baseline_torch.json``."""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.__main__ import analyze as jax_analyze
from repro_torch.analysis.__main__ import analyze, default_root, main
from repro_torch.analysis.baseline import diff_findings, load_baseline
from repro_torch.analysis.project import Project
from repro_torch.analysis.rules.kernel_lint import kernel_wrappers

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHARED = ("LO", "GB", "BL", "RT", "CH")
PORT_KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
                "decode_attention_lse", "paged_decode_attention",
                "paged_verify_attention", "rmsnorm", "ssd_scan")


def _jax_fixtures() -> dict:
    """``FIXTURES`` of ``tests/test_analysis.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_jax_analysis_fixtures", ROOT / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FIXTURES


def _write_tree(root: Path, files: dict) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).lstrip("\n"))
    return root


def _facts(findings):
    return sorted((f.id, f.rule, f.severity, f.line) for f in findings)


@pytest.fixture(scope="module")
def shared_root(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("shared"), _jax_fixtures())


@pytest.mark.parametrize("family", SHARED)
def test_shared_fixtures_give_jax_findings(shared_root, family):
    want = _facts(jax_analyze(shared_root, [family])[1])
    got = _facts(analyze(shared_root, [family])[1])
    assert want, f"{family} fires nothing on the shared fixtures"
    assert got == want


@pytest.mark.parametrize("tree,family",
                         [("repro", f) for f in SHARED]
                         + [("repro_torch", f) for f in SHARED if f != "CH"])
def test_package_trees_give_jax_findings(tree, family):
    """Over the JAX package, and over the port for the families whose
    scope is the tree alone (CH also reads the sibling tests, by root
    name: the port's analyzer reads ``test_torch_*.py`` for the port)."""
    root = ROOT / "src" / tree
    assert _facts(analyze(root, [family])[1]) == \
        _facts(jax_analyze(root, [family])[1])


def test_chaos_coverage_reads_the_ports_tests():
    """Every chaos kind of the port is covered by ``test_torch_*.py``;
    over the JAX package's root the port reads what JAX reads."""
    port = analyze(ROOT / "src" / "repro_torch", ["CH"])[1]
    assert port == []
    kinds = ("engine-stall", "node-loss", "node-rejoin", "quota-set",
             "quota-clear")
    src = (ROOT / "src" / "repro_torch" / "harness" / "chaos.py").read_text()
    assert all(f'"{k}"' in src for k in kinds)


# ---------------------------------------------------------------------------
# KL: the CUDA kernel wrappers
# ---------------------------------------------------------------------------

KL_FIXTURES = {
    "csrc/good.cu": "// a kernel source\n",
    "kernels/build.py": """
        def load(name):
            raise RuntimeError(name)
    """,
    "kernels/ref.py": """
        def no_fallback(x, *, eps=1e-6):
            return x

        def fallback(x):
            return x

        def mismatch(x, scale):
            return x

        def dynamic(x, name):
            return x

        def missing(x):
            return x

        def mha(q, k, *, return_lse=False):
            return q
    """,
    "kernels/wrappers.py": """
        from fixture.kernels import build, ref

        _fn = None


        class KernelError(RuntimeError):
            pass


        def _entry():
            global _fn
            if _fn is None:
                _fn = build.load("good")
            return _fn


        def _launch(x):
            return _entry()(x)


        def no_oracle(x):
            return _launch(x)


        def no_fallback(x, *, eps=1e-6, block_rows=8):
            try:
                return _launch(x)
            except OSError as e:
                raise KernelError(f"launch failed: {e}") from e


        def fallback(x):
            try:
                return _launch(x)
            except Exception:
                return ref.fallback(x)


        def mismatch(x, y):
            return _entry()(x, y)


        def dynamic(x, name):
            return build.load(name)(x)


        def missing(x):
            return build.load("nope")(x)


        def attention(q, k, *, return_lse=False):  # analysis: oracle=mha
            return _launch(q)


        def with_lse(q, k):  # analysis: oracle=mha
            return _launch(q)


        def plain(x):
            return ref.mha(x, x)
    """,
}


@pytest.fixture(scope="module")
def kl_root(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("kl"), KL_FIXTURES)


@pytest.fixture(scope="module")
def kl_ids(kl_root):
    return {f.id for f in analyze(kl_root, ["KL"])[1]}


def test_kl_finds_the_wrappers_through_private_hops(kl_root):
    names = {name for _, name, _ in kernel_wrappers(Project(kl_root))}
    assert names == {"no_oracle", "no_fallback", "fallback", "mismatch",
                     "dynamic", "missing", "attention", "with_lse"}


@pytest.mark.parametrize("fid", [
    "KL001:kernels/wrappers.py:fallback:fallback",
    "KL002:kernels/wrappers.py:dynamic:load",
    "KL002:kernels/wrappers.py:missing:load",
    "KL003:kernels/wrappers.py:no_oracle",
    "KL004:kernels/wrappers.py:mismatch~mismatch",
])
def test_kl_fixture_fires(kl_ids, fid):
    assert fid in kl_ids


def test_kl_clean_wrappers_stay_silent(kl_ids):
    """A re-raise is not a fallback, wrapper-only tuning parameters are
    allowed, ``oracle=`` names the oracle, and ``return_lse`` may stand on
    either side alone; private helpers and functions that never reach
    ``build.load`` are not wrappers."""
    quiet = ("no_fallback", "attention", "with_lse", "plain", "_entry",
             "_launch")
    assert not [i for i in kl_ids if i.split(":")[2].split("~")[0]
                in quiet]
    assert len(kl_ids) == 5


def test_kl_finds_every_port_kernel_wrapper():
    found = kernel_wrappers(Project(ROOT / "src" / "repro_torch"))
    names = {name for _, name, _ in found}
    assert set(PORT_KERNELS) <= names
    assert names - set(PORT_KERNELS) == {"flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv"}
    assert all(path.startswith("kernels/") for path, _, _ in found)


# the dispatch layer and a model over the same wrappers: KL001 around a
# launcher outside the wrappers' own modules
KL_CALLER_FIXTURES = dict(KL_FIXTURES, **{
    "kernels/ops.py": """
        from fixture.kernels import ref
        from fixture.kernels.wrappers import no_fallback as _nf


        def dispatch(x):
            fn = _nf if x else ref.no_fallback
            return fn(x)


        def dispatch_fallback(x):
            try:
                return _nf(x)
            except Exception:
                return ref.no_fallback(x)
    """,
    "models/layer.py": """
        from fixture.kernels import ops, ref


        def block(x):
            return ops.dispatch(x)


        def forward_fallback(x):
            try:
                return ops.dispatch(x)
            except RuntimeError:
                return ref.no_fallback(x)


        def through_block(x):
            try:
                return block(x)
            except RuntimeError:
                pass
            return x


        class Layer:
            def __call__(self, x):
                try:
                    return ops.dispatch(x)
                except RuntimeError as e:
                    raise ValueError("launch failed") from e


        def unrelated(path):
            try:
                return open(path).read()
            except OSError:
                return ""
    """,
})
KL_CALLER_IDS = ("KL001:kernels/ops.py:dispatch_fallback:fallback",
                 "KL001:models/layer.py:forward_fallback:fallback",
                 "KL001:models/layer.py:through_block:fallback")


@pytest.fixture(scope="module")
def kl_caller_ids(tmp_path_factory):
    root = _write_tree(tmp_path_factory.mktemp("klcall"), KL_CALLER_FIXTURES)
    return {f.id for f in analyze(root, ["KL"])[1]}


@pytest.mark.parametrize("fid", KL_CALLER_IDS)
def test_kl001_fires_around_a_launcher_outside_the_wrappers(kl_caller_ids,
                                                            fid):
    assert fid in kl_caller_ids


def test_kl001_callers_stay_silent_on_reraise_and_other_calls(kl_ids,
                                                              kl_caller_ids):
    """A re-raise around a dispatch, a ``try`` around no launch, and the
    dispatch's own device switch are not fallbacks; the wrappers' own
    findings are unchanged."""
    assert kl_caller_ids - kl_ids == set(KL_CALLER_IDS)
    assert kl_ids <= kl_caller_ids


def test_kl_is_silent_on_the_jax_package():
    """The JAX kernels reach ``pl.pallas_call``, never ``build.load``."""
    assert analyze(ROOT / "src" / "repro", ["KL"])[1] == []


# ---------------------------------------------------------------------------
# the CLI and the committed baseline
# ---------------------------------------------------------------------------

def test_cli_exit_codes(shared_root, tmp_path, capsys):
    assert main(["--root", str(shared_root), "--check"]) == 1
    base = tmp_path / "b.json"
    assert main(["--root", str(shared_root), "--baseline", str(base),
                 "--update-baseline"]) == 0
    assert main(["--root", str(shared_root), "--baseline", str(base),
                 "--check"]) == 0
    assert main(["--root", str(shared_root), "--rules", "NOPE"]) == 2
    assert main(["--root", str(shared_root), "--update-baseline"]) == 2
    assert main(["--root", str(tmp_path / "absent")]) == 2
    capsys.readouterr()
    assert main(["--root", str(shared_root), "--rules", "gb"]) == 0
    assert "kernel wrappers" not in capsys.readouterr().out


def test_cli_json_report(kl_root, shared_root, tmp_path, capsys):
    out = tmp_path / "report.json"
    assert main(["--root", str(kl_root), "--json", str(out)]) == 0
    assert "kernel wrappers (KL): 8" in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert len(report["new"]) == 5 and report["modules"] == 3
    assert {w["name"] for w in report["kernel_wrappers"]} >= {"fallback"}
    assert {r["family"] for r in report["rules"]} == set(SHARED) | {"KL"}
    main(["--root", str(shared_root), "--json", str(out)])
    graph = json.loads(out.read_text())["lock_graph"]["edges"]
    assert any(e["src"] == "A._lock" and e["dst"] == "B._lock"
               for e in graph)


def test_port_tree_clean_against_committed_baseline():
    """The gate: no new finding on ``src/repro_torch`` against
    ``analysis_baseline_torch.json``, no stale entry, every entry a
    note, and the two GB001 and five CH001 findings of the port's first
    analysis fixed rather than baselined."""
    assert default_root() == ROOT / "src" / "repro_torch"
    baseline = load_baseline(ROOT / "analysis_baseline_torch.json")
    _, findings = analyze(default_root())
    new, known, stale = diff_findings(findings, baseline)
    assert not new, [f.id for f in new]
    assert not stale, stale
    assert all(v["note"] and "TODO" not in v["note"]
               for v in baseline.values())
    assert not [k for k in baseline if k.startswith(("GB", "CH"))]
    assert sorted(f.rule for f in known) == ["BL001", "BL001", "KL003",
                                             "KL003", "LO003", "LO003"]


def test_cli_gate_runs_without_torch_jax_or_repro(tmp_path):
    """``python -m repro_torch.analysis --check`` as CI would run it, in a
    process where torch, JAX and the JAX package cannot be imported."""
    code = textwrap.dedent("""
        import runpy, sys
        for name in ("torch", "jax", "repro", "numpy"):
            sys.modules[name] = None
        sys.argv = ["repro_torch.analysis", "--check", "--baseline",
                    sys.argv[1], "--json", sys.argv[2]]
        try:
            runpy.run_module("repro_torch.analysis", run_name="__main__")
        except SystemExit as e:
            sys.exit(e.code)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    report = tmp_path / "r.json"
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "analysis_baseline_torch.json"),
         str(report)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new finding(s), 6 baselined" in out.stdout
    assert len(json.loads(report.read_text())["kernel_wrappers"]) == 10

"""CH001 — every chaos action kind has a recovery assertion in tests.

The chaos harness (``harness/chaos.py``) enumerates its fault vocabulary
in one module-level ``KINDS`` tuple.  Each kind is only trustworthy if
some replay test *injects* it and *asserts* recovery afterwards — a kind
that exists in the vocabulary but never appears inside an asserting test
is a fault path nobody has ever watched heal.

Coverage criterion (deliberately syntactic, like the other rules): a
kind ``k`` is covered when at least one test function (``def test*``)
contains ``k`` as a string literal **and** contains at least one
``assert`` statement.  Test functions are harvested from ``test_*.py``
modules inside the analysis root and — when the root is an installed
package — from the repo's sibling ``tests/`` directory, parsed ad hoc
(the package root itself ships no tests): ``test_torch_*.py`` for the
port ``repro_torch``, every ``test_*.py`` for the reference ``repro``.

Suppression: a ``# analysis: chaos-untested-ok`` pragma on the line of
the kind's string literal inside the ``KINDS`` tuple skips that kind
(for vocabulary reserved ahead of its harness support).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import ModuleInfo, Project
from repro_torch.analysis.rules import Rule

KINDS_NAME = "KINDS"
CHAOS_BASENAME = "chaos.py"
#: analysis-root name → the sibling ``tests/`` files that cover it
SIBLING_TESTS = {"repro_torch": "test_torch_*.py", "repro": "test_*.py"}


def _find_kinds(project: Project):
    """Locate the ``KINDS = (...)`` tuple of string constants in the
    project's ``chaos.py`` module.  Returns ``(relpath, mod, line,
    [(kind, line), ...])`` or ``None`` when the project has no chaos
    vocabulary (fixture trees without a harness stay silent)."""
    for rel, mod in sorted(project.modules.items()):
        if Path(rel).name != CHAOS_BASENAME:
            continue
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if KINDS_NAME not in targets:
                continue
            if not isinstance(node.value, (ast.Tuple, ast.List)):
                continue
            kinds: List[Tuple[str, int]] = []
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) \
                        and isinstance(elt.value, str):
                    kinds.append((elt.value, elt.lineno))
            if kinds:
                return rel, mod, node.lineno, kinds
    return None


def _test_functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name.startswith("test"):
            yield node


def _asserting_literals(fn: ast.FunctionDef) -> frozenset:
    """String literals appearing in ``fn`` — empty set when the function
    never asserts (a test that injects but checks nothing covers
    nothing)."""
    has_assert = any(isinstance(n, ast.Assert) for n in ast.walk(fn))
    if not has_assert:
        return frozenset()
    return frozenset(n.value for n in ast.walk(fn)
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str))


def _test_trees(project: Project) -> Iterator[ast.Module]:
    for rel, mod in sorted(project.modules.items()):
        if Path(rel).name.startswith("test_"):
            yield mod.tree
    # an installed package's tests live outside it at <repo>/tests —
    # parse those ad hoc: the port's own for ``repro_torch``, all of them
    # for the reference package ``repro``
    pattern = SIBLING_TESTS.get(project.root.name)
    if pattern is not None:
        ext = project.root.parent.parent / "tests"
        if ext.is_dir():
            for path in sorted(ext.glob(pattern)):
                try:
                    yield ast.parse(path.read_text(),
                                    filename=str(path))
                except (OSError, SyntaxError):
                    continue


class ChaosCoverage(Rule):
    family = "CH"
    name = "chaos-recovery-coverage"
    description = ("every ChaosAction kind in harness KINDS appears in "
                   "at least one asserting replay test")

    def run(self, project: Project) -> Iterator[Finding]:
        found = _find_kinds(project)
        if found is None:
            return
        rel, mod, kinds_line, kinds = found
        covered = set()
        for tree in _test_trees(project):
            for fn in _test_functions(tree):
                covered |= _asserting_literals(fn)
        for kind, line in kinds:
            if kind in covered:
                continue
            if mod.pragma_at(line, "chaos-untested-ok"):
                continue
            yield Finding(
                rule="CH001", severity=Severity.ERROR, path=rel,
                line=line, anchor=kind,
                message=(f"chaos kind {kind!r} has no recovery "
                         f"assertion: no test function both injects it "
                         f"and asserts afterwards"))

"""KL — CUDA kernel-wrapper lint (modules under ``kernels/`` only).

A *kernel wrapper* is a public module-level function of a ``kernels/``
module (outside ``EXCLUDED``) that reaches ``build.load(...)``: directly,
or through the module's own functions (a fixpoint over the module's
call graph, so ``_entry()``/``_launch()`` hops count).  The rules hold
the port's contract that every kernel is launched or raises, that what
the card compiles is fixed in the repo, and that every kernel has a
drop-in plain version in ``kernels/ref.py``.

- **KL001** (error): a ``try`` around a launch whose handler does not
  re-raise — it returns, or falls through.  That is a silent fallback
  (to ``ref.*``, or to nothing); a kernel that fails to build or launch
  must raise.  It is looked for on a wrapper's path (the wrapper or a
  module function it reaches ``build.load`` through) and, in every
  other module but ``ref.py``, around a call of a *launcher*: a
  wrapper, a ``kernels/`` function or class that reaches one (the
  dispatch in ``ops.py``), or a function of the same module that
  does.  Launchers are named through the module's imports
  (``from ...kernels.ops import flash_attention``, ``ops.rmsnorm``).
- **KL002** (error): a ``build.load`` whose argument is not one string
  literal naming a ``csrc/<name>.cu`` of the analysed tree (``csrc``
  beside ``kernels/``).  What the card compiles must be fixed in the
  repo, as a Pallas block shape must be static.
- **KL003** (error): a kernel wrapper with no same-named oracle in
  ``kernels/ref.py``.  ``# analysis: oracle=<name>`` on the ``def`` line
  maps a wrapper to a differently-named oracle (e.g. ``flash_attention``
  → ``mha``).
- **KL004** (error): the wrapper/oracle signatures differ beyond the
  wrapper-only tuning/debug parameters and the extended-return switches
  either side may carry alone (``return_lse``).  Oracles must be drop-in
  replacements.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import ModuleInfo, Project, attr_chain
from repro_torch.analysis.rules import Rule

REF_MODULE = "ref.py"
EXCLUDED = {"ref.py", "ops.py", "__init__.py"}
CSRC_DIR = "csrc"

#: parameters a kernel may carry that its oracle does not: interpreter
#: toggles, block-size tuning, and extended-return switches used by
#: autograd plumbing
KERNEL_ONLY_PARAMS = {"interpret", "debug", "block_q", "block_k",
                      "block_rows", "block_d", "block", "num_warps",
                      "num_stages", "return_lse"}

#: extended-return switches an oracle may carry that its kernel does not
#: (one oracle serves a kernel with and a kernel without the extra
#: output, e.g. ``decode_attention`` and ``decode_attention_lse``)
ORACLE_ONLY_PARAMS = {"return_lse"}


def _kernel_modules(project: Project):
    for rel, mod in project.modules.items():
        parts = rel.split("/")
        if "kernels" in parts[:-1] and parts[-1] not in EXCLUDED:
            yield rel, mod


def _ref_functions(project: Project) -> Dict[str, ast.FunctionDef]:
    for rel, mod in project.modules.items():
        parts = rel.split("/")
        if "kernels" in parts[:-1] and parts[-1] == REF_MODULE:
            return _module_functions(mod)
    return {}


def _module_functions(mod: ModuleInfo) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in mod.tree.body
            if isinstance(n, ast.FunctionDef)}


def _param_names(fn: ast.FunctionDef) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def _is_load(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return bool(chain) and chain[-2:] == ["build", "load"]


def _local_calls(node: ast.AST, names: Set[str]) -> Set[str]:
    """Names of the module's own functions that ``node`` calls."""
    return {n.func.id for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id in names}


def _launching(funcs: Dict[str, ast.FunctionDef]) -> Set[str]:
    """The module functions that reach ``build.load``: a fixpoint over
    the module's call graph."""
    names = set(funcs)
    calls = {name: _local_calls(fn, names) for name, fn in funcs.items()}
    out = {name for name, fn in funcs.items()
           if any(_is_load(n) for n in ast.walk(fn))}
    changed = True
    while changed:
        changed = False
        for name in names - out:
            if calls[name] & out:
                out.add(name)
                changed = True
    return out


def kernel_wrappers(project: Project) -> List[Tuple[str, str, int]]:
    """``(relpath, name, line)`` of every kernel wrapper in the tree."""
    found = []
    for rel, mod in sorted(_kernel_modules(project)):
        funcs = _module_functions(mod)
        for name in sorted(_launching(funcs)):
            if not name.startswith("_"):
                found.append((rel, name, funcs[name].lineno))
    return found


def _module_names(project: Project) -> Dict[str, str]:
    """Dotted name below the root (``kernels.ops``; a package by its
    directory) → relpath."""
    out = {}
    for rel in project.modules:
        parts = rel[:-3].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = rel
    return out


def _find_module(names: Dict[str, str], dotted: str) -> Optional[str]:
    """The relpath an absolute import names: its dotted name with the
    leading packages (the root's own name) dropped until it names a
    module of the tree."""
    parts = dotted.split(".")
    for i in range(len(parts)):
        rel = names.get(".".join(parts[i:]))
        if rel is not None:
            return rel
    return None


def _imports(names: Dict[str, str], rel: str,
             mod: ModuleInfo) -> Dict[str, Tuple[str, ...]]:
    """Each name a module binds by import → ``("mod", relpath)`` or
    ``("def", relpath, name)``."""
    out: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                target = _find_module(names, a.name)
                if a.asname and target:
                    out[a.asname] = ("mod", target)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg = rel.split("/")[:-1]
                pkg = pkg[:len(pkg) - (node.level - 1)]
                base = ".".join(pkg + (node.module or "").split("."))
                base = base.strip(".")
                owner = names.get(base)
                sub = lambda n: names.get(f"{base}.{n}".strip("."))
            else:
                owner = _find_module(names, node.module or "")
                sub = lambda n: _find_module(names, f"{node.module}.{n}")
            for a in node.names:
                target = sub(a.name)
                if target:
                    out[a.asname or a.name] = ("mod", target)
                elif owner:
                    out[a.asname or a.name] = ("def", owner, a.name)
    return out


def _top_defs(mod: ModuleInfo) -> Dict[str, ast.AST]:
    return {n.name: n for n in mod.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _refers(node: ast.AST, imports: Dict[str, Tuple[str, ...]],
            launchers: Set[Tuple[str, str]], local: Set[str]) -> bool:
    """Whether ``node`` names a launcher: an imported one, one as an
    attribute of an imported module, or a launching def of its own
    module."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            if n.id in local:
                return True
            imp = imports.get(n.id)
            if imp and imp[0] == "def" and imp[1:] in launchers:
                return True
        elif isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name):
            imp = imports.get(n.value.id)
            if imp and imp[0] == "mod" and (imp[1], n.attr) in launchers:
                return True
    return False


def _local_launchers(mod: ModuleInfo, imports: Dict[str, Tuple[str, ...]],
                     launchers: Set[Tuple[str, str]]) -> Set[str]:
    """A module's own functions and classes that name a launcher,
    directly or through each other (a fixpoint)."""
    defs = _top_defs(mod)
    out: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, node in defs.items():
            if name not in out and _refers(node, imports, launchers, out):
                out.add(name)
                changed = True
    return out


def _functions(node: ast.AST, prefix: str = "") \
        -> Iterator[Tuple[str, ast.AST]]:
    """Every function of a module with its dotted name in the module."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield prefix + child.name, child
            yield from _functions(child, f"{prefix}{child.name}.")
        elif isinstance(child, ast.ClassDef):
            yield from _functions(child, f"{prefix}{child.name}.")
        else:
            yield from _functions(child, prefix)


def _own_tries(fn: ast.AST) -> Iterator[ast.Try]:
    """The ``try`` statements of ``fn`` outside its nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Try):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _reraises(handler: ast.ExceptHandler) -> bool:
    """A handler re-raises when it never returns and its last statement
    is a ``raise`` (bare, or a new error chained onto the caught one)."""
    if any(isinstance(n, ast.Return) for n in ast.walk(handler)):
        return False
    return bool(handler.body) and isinstance(handler.body[-1], ast.Raise)


def _csrc_names(project: Project, rel: str) -> Set[str]:
    csrc = (project.root / rel).parent.parent / CSRC_DIR
    return {p.stem for p in csrc.glob("*.cu")} if csrc.is_dir() else set()


class KernelLint(Rule):
    family = "KL"
    name = "kernel-lint"
    description = ("CUDA kernel wrappers: no silent fallback around a "
                   "launch, build.load of a literal csrc/<name>.cu, and a "
                   "signature-matched ref.py oracle per public wrapper")

    def run(self, project: Project) -> Iterator[Finding]:
        refs = _ref_functions(project)
        for rel, mod in _kernel_modules(project):
            funcs = _module_functions(mod)
            launching = _launching(funcs)
            sources = _csrc_names(project, rel)
            for name in sorted(launching):
                fn = funcs[name]
                yield from self._fallbacks(rel, name, fn, launching)
                yield from self._loads(rel, name, fn, sources)
            for name in sorted(launching):
                if not name.startswith("_"):
                    yield from self._oracle(rel, mod, funcs[name], refs)
        yield from self._callers(project)

    def _callers(self, project: Project) -> Iterator[Finding]:
        """KL001 outside the wrappers' own modules: the launchers are the
        wrappers' paths, then what of ``kernels/`` names them (a
        fixpoint); every other module's ``try`` around one is held to the
        same rule."""
        names = _module_names(project)
        own = dict(_kernel_modules(project))
        launchers = {(rel, name) for rel, mod in own.items()
                     for name in _launching(_module_functions(mod))}
        imports = {rel: _imports(names, rel, mod)
                   for rel, mod in project.modules.items()}
        package = [rel for rel in project.modules
                   if "kernels" in rel.split("/")[:-1]
                   and rel.split("/")[-1] != REF_MODULE]
        changed = bool(launchers)
        while changed:
            changed = False
            for rel in package:
                for name in _local_launchers(project.modules[rel],
                                             imports[rel], launchers):
                    if (rel, name) not in launchers:
                        launchers.add((rel, name))
                        changed = True
        if not launchers:
            return
        for rel, mod in sorted(project.modules.items()):
            if rel in own or rel.split("/")[-1] == REF_MODULE:
                continue
            local = _local_launchers(mod, imports[rel], launchers)
            for qual, fn in _functions(mod.tree):
                for node in _own_tries(fn):
                    body = ast.Module(body=node.body, type_ignores=[])
                    if not _refers(body, imports[rel], launchers, local):
                        continue
                    bad = [h for h in node.handlers if not _reraises(h)]
                    if bad:
                        yield Finding(
                            rule="KL001", severity=Severity.ERROR,
                            path=rel, line=bad[0].lineno,
                            anchor=f"{qual}:fallback",
                            message=(f"{qual} catches an exception around "
                                     f"a kernel launch and does not "
                                     f"re-raise — a silent fallback; a "
                                     f"kernel must launch or raise"))

    def _fallbacks(self, rel: str, name: str, fn: ast.FunctionDef,
                   launching: Set[str]) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            body = ast.Module(body=node.body, type_ignores=[])
            launches = any(_is_load(n) for n in ast.walk(body)) or \
                bool(_local_calls(body, launching))
            if not launches:
                continue
            for handler in node.handlers:
                if not _reraises(handler):
                    yield Finding(
                        rule="KL001", severity=Severity.ERROR, path=rel,
                        line=handler.lineno, anchor=f"{name}:fallback",
                        message=(f"{name} catches an exception around its "
                                 f"kernel launch and does not re-raise — "
                                 f"a silent fallback; a kernel must launch "
                                 f"or raise"))
                    return

    def _loads(self, rel: str, name: str, fn: ast.FunctionDef,
               sources: Set[str]) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not _is_load(node):
                continue
            arg = node.args[0] if len(node.args) == 1 and \
                not node.keywords else None
            literal = isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str)
            if literal and arg.value in sources:
                continue
            what = (f"'{arg.value}' names no {CSRC_DIR}/{arg.value}.cu"
                    if literal else "its argument is not a string literal")
            yield Finding(
                rule="KL002", severity=Severity.ERROR, path=rel,
                line=node.lineno, anchor=f"{name}:load",
                message=(f"build.load in {name}: {what} — the source the "
                         f"card compiles must be fixed in the repo"))
            return

    def _oracle(self, rel: str, mod: ModuleInfo, node: ast.FunctionDef,
                refs: Dict[str, ast.FunctionDef]) -> Iterator[Finding]:
        pragma = mod.pragma_at(node.lineno, "oracle")
        oracle_name: Optional[str] = pragma.value if pragma else node.name
        oracle = refs.get(oracle_name or "")
        if oracle is None:
            yield Finding(
                rule="KL003", severity=Severity.ERROR, path=rel,
                line=node.lineno, anchor=node.name,
                message=(f"public kernel {node.name} has no ref.py oracle "
                         f"named '{oracle_name}'"))
            return
        kparams = _param_names(node) - KERNEL_ONLY_PARAMS
        oparams = _param_names(oracle) - ORACLE_ONLY_PARAMS
        if kparams != oparams:
            missing = sorted(oparams - kparams)
            extra = sorted(kparams - oparams)
            yield Finding(
                rule="KL004", severity=Severity.ERROR, path=rel,
                line=node.lineno, anchor=f"{node.name}~{oracle_name}",
                message=(f"kernel {node.name} and oracle {oracle_name} "
                         f"signatures differ (oracle-only: {missing}, "
                         f"kernel-only: {extra})"))

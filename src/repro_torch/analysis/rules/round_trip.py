"""RT — dataclass round-trip completeness.

For every ``@dataclass`` that defines both halves of a serialization
pair — ``to_dict``/``from_dict`` or ``to_json``/``from_json`` — each
declared field must be emitted by the writer and accepted by the reader,
so persisted specs never silently drop state across a save/restore.

- **RT001** (error): field missing from the ``to_dict``/``to_json``
  output dict.
- **RT002** (error): field missing from the ``from_dict``/``from_json``
  constructor call.

Wildcards end the check early: ``dataclasses.asdict(self)`` (writer) and
``cls(**d)`` (reader) cover every field.  Fields that are derived (not
round-tripped by design) are excluded with ``# analysis: derived`` on
the field's declaration line; ``field(init=False)`` fields are skipped
on the reader side automatically.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import ModuleInfo, Project, attr_chain
from repro_torch.analysis.rules import Rule

PAIRS = (("to_dict", "from_dict"), ("to_json", "from_json"))


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        chain = attr_chain(dec.func if isinstance(dec, ast.Call) else dec)
        if chain and chain[-1] == "dataclass":
            return True
    return False


def _fields(node: ast.ClassDef, mod: ModuleInfo) \
        -> List[Tuple[str, int, bool, bool]]:
    """(name, line, derived, init_false) per declared field."""
    out = []
    for item in node.body:
        if not isinstance(item, ast.AnnAssign) or \
                not isinstance(item.target, ast.Name):
            continue
        name = item.target.id
        if name.startswith("_"):
            continue
        ann = ast.dump(item.annotation)
        if "ClassVar" in ann:
            continue
        derived = mod.pragma_at(item.lineno, "derived") is not None
        init_false = False
        if isinstance(item.value, ast.Call):
            chain = attr_chain(item.value.func)
            if chain and chain[-1] == "field":
                for kw in item.value.keywords:
                    if kw.arg == "init" and isinstance(
                            kw.value, ast.Constant) and \
                            kw.value.value is False:
                        init_false = True
        out.append((name, item.lineno, derived, init_false))
    return out


def _method(node: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for item in node.body:
        if isinstance(item, ast.FunctionDef) and item.name == name:
            return item
    return None


def _writer_keys(fn: ast.FunctionDef) -> Optional[Set[str]]:
    """String keys emitted into any dict literal in the writer; None
    means 'everything' (asdict-style wildcard)."""
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in ("asdict", "_asdict"):
                return None
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is None:
                    # ``**other`` merge: unknown contents → wildcard
                    return None
                if isinstance(k, ast.Constant) and isinstance(
                        k.value, str):
                    keys.add(k.value)
    return keys


def _reader_keys(fn: ast.FunctionDef, cls_name: str) -> Optional[Set[str]]:
    """Keyword/positional field names passed to the constructor in the
    reader; None means 'everything' (``cls(**d)``)."""
    names: Set[str] = set()
    found = False
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or chain[-1] not in ("cls", cls_name):
            continue
        found = True
        for kw in node.keywords:
            if kw.arg is None:
                return None
            names.add(kw.arg)
        # positional args map onto leading declared fields — handled by
        # the caller, which knows declaration order
        names.add(f"__positional__{len(node.args)}")
    return names if found else None


class RoundTripCompleteness(Rule):
    family = "RT"
    name = "round-trip"
    description = ("dataclasses with to_dict/from_dict (or to_json/"
                   "from_json) must emit and accept every non-derived "
                   "field")

    def run(self, project: Project) -> Iterator[Finding]:
        for rel, mod in project.modules.items():
            for node in mod.tree.body:
                if not isinstance(node, ast.ClassDef) or \
                        not _is_dataclass(node):
                    continue
                for to_name, from_name in PAIRS:
                    writer = _method(node, to_name)
                    reader = _method(node, from_name)
                    if writer is None or reader is None:
                        continue
                    yield from self._check(rel, mod, node, writer,
                                           reader)
                    break  # one pair per class is enough

    def _check(self, rel: str, mod: ModuleInfo, node: ast.ClassDef,
               writer: ast.FunctionDef, reader: ast.FunctionDef) \
            -> Iterator[Finding]:
        fields = _fields(node, mod)
        wkeys = _writer_keys(writer)
        rkeys = _reader_keys(reader, node.name)
        n_positional = 0
        if rkeys is not None:
            for k in list(rkeys):
                if k.startswith("__positional__"):
                    n_positional = max(n_positional,
                                       int(k[len("__positional__"):]))
                    rkeys.discard(k)
        for i, (name, line, derived, init_false) in enumerate(fields):
            if derived:
                continue
            if wkeys is not None and name not in wkeys:
                yield Finding(
                    rule="RT001", severity=Severity.ERROR, path=rel,
                    line=line, anchor=f"{node.name}.{name}",
                    message=(f"{node.name}.{name} never emitted by "
                             f"{writer.name}() — persisted copies "
                             f"drop it"))
            if init_false:
                continue
            covered_positionally = i < n_positional
            if rkeys is not None and name not in rkeys and \
                    not covered_positionally:
                yield Finding(
                    rule="RT002", severity=Severity.ERROR, path=rel,
                    line=line, anchor=f"{node.name}.{name}",
                    message=(f"{node.name}.{name} never passed to the "
                             f"constructor in {reader.name}() — "
                             f"restores lose it"))

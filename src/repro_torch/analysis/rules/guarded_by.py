"""GB — guarded-by inference.

For every class that declares locks: a field written under one of the
class's own locks in any method (outside ``__init__``/``__post_init__``)
is inferred lock-guarded; any other read/write of that field with no
class lock held is a finding.

"Lock held" means: a direct ``with self._lock`` region, a method whose
name ends ``_locked`` (held-on-entry by convention), or an *effectively
locked* private method — one whose every intra-class call site runs
under a class lock (computed as a fixpoint, so chains of private helpers
called from a locked public method all count).

- **GB001** (error): lock-free access to a lock-guarded field.

Escape hatch: ``# analysis: unguarded-ok`` on the access line, or on the
enclosing method's ``def`` line to cover a deliberate lock-free method
(e.g. a racy-but-atomic bool read).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import FieldAccess, MethodInfo, Project
from repro_torch.analysis.rules import Rule

INIT_METHODS = ("__init__", "__post_init__", "__new__")


class GuardedByInference(Rule):
    family = "GB"
    name = "guarded-by"
    description = ("fields written under a class lock must not be "
                   "accessed lock-free elsewhere")

    def run(self, project: Project) -> Iterator[Finding]:
        for cls in project.classes.values():
            own = cls.own_lock_ids
            if not own:
                continue
            mod = project.modules[cls.module]
            eff_locked = project.effectively_locked(cls)

            def held(meth: MethodInfo, acc: FieldAccess) -> bool:
                return bool(set(acc.held) & own) or meth.name in eff_locked

            guarded = set()
            accesses: Dict[str, List[Tuple[MethodInfo, FieldAccess]]] = {}
            for meth in cls.methods.values():
                for acc in meth.accesses:
                    if acc.attr in cls.locks:
                        continue
                    accesses.setdefault(acc.attr, []).append((meth, acc))
                    if meth.name not in INIT_METHODS and \
                            acc.kind == "write" and held(meth, acc):
                        guarded.add(acc.attr)

            for field in sorted(guarded):
                flagged = set()
                for meth, acc in accesses[field]:
                    if meth.name in INIT_METHODS or held(meth, acc):
                        continue
                    if mod.pragma_at(acc.line, "unguarded-ok") or \
                            mod.pragma_at(meth.def_line, "unguarded-ok"):
                        continue
                    anchor = f"{cls.name}.{field}@{meth.name}"
                    if anchor in flagged:
                        continue
                    flagged.add(anchor)
                    yield Finding(
                        rule="GB001", severity=Severity.ERROR,
                        path=cls.module, line=acc.line, anchor=anchor,
                        message=(f"{cls.name}.{field} is written under "
                                 f"{'/'.join(sorted(own))} but "
                                 f"{acc.kind} lock-free in "
                                 f"{meth.name}()"))

"""BL — blocking-while-locked.

Inside a held-lock region (any lock, including ``with`` targets we can
only identify as lock-*shaped*), flag calls that can block indefinitely
or for wall-clock time:

- **BL001** (warning): ``time.sleep(...)`` under a lock.
- **BL002** (error): ``<future>.result(...)`` under a lock — waits on
  another thread that may need the same lock.
- **BL003** (error): ``<thread>.join(...)`` under a lock.  ``str.join``
  is excluded by shape (an argument that is a non-numeric literal or a
  comprehension/generator marks string joins).
- **BL004** (error): ``<condition>.wait(...)`` where the condition's
  underlying lock is *not* the lock currently held.  Waiting on a
  condition of the lock you hold (``self._work.wait()`` under
  ``self._lock`` when ``_work = Condition(_lock)``) releases it and is
  the intended idiom — never flagged.

Suppress a deliberate site with a baseline entry (preferred — keeps the
justification reviewable) or ``# analysis: blocking-ok`` on the line.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import CallSite, Project, attr_chain
from repro_torch.analysis.rules import Rule


def _is_str_join(call: ast.Call) -> bool:
    """``"sep".join(xs)`` / ``", ".join(...)`` shapes: receiver is a
    string literal, or the single argument is an iterable-of-strings
    shape (comprehension, generator, list/tuple literal)."""
    func = call.func
    if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Constant) and isinstance(func.value.value, str):
        return True
    if call.args and isinstance(
            call.args[0], (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                           ast.List, ast.Tuple, ast.Call)):
        return True
    return False


class BlockingWhileLocked(Rule):
    family = "BL"
    name = "blocking-while-locked"
    description = ("no sleeps, future results, joins, or foreign "
                   "condition waits inside a held-lock region")

    def run(self, project: Project) -> Iterator[Finding]:
        for cls in project.classes.values():
            mod = project.modules[cls.module]
            for meth in cls.methods.values():
                where = f"{cls.name}.{meth.name}"
                seen = set()
                for call in meth.calls:
                    if not call.held:
                        continue
                    if mod.pragma_at(call.line, "blocking-ok"):
                        continue
                    f = self._check(project, cls, where, call)
                    if f is not None and f.id not in seen:
                        seen.add(f.id)
                        yield f

    def _check(self, project, cls, where: str, call: CallSite):
        chain = call.chain
        leaf = chain[-1]
        held = ", ".join(sorted(call.held))
        if chain == ("time", "sleep"):
            return Finding(
                rule="BL001", severity=Severity.WARNING,
                path=cls.module, line=call.line,
                anchor=f"{where}:time.sleep",
                message=f"time.sleep under held lock [{held}] in "
                        f"{where}")
        if leaf == "result" and len(chain) >= 2:
            return Finding(
                rule="BL002", severity=Severity.ERROR,
                path=cls.module, line=call.line,
                anchor=f"{where}:{'.'.join(chain)}",
                message=f"blocking .result() under held lock [{held}] "
                        f"in {where}")
        if leaf == "join" and not _is_str_join(call.node):
            return Finding(
                rule="BL003", severity=Severity.ERROR,
                path=cls.module, line=call.line,
                anchor=f"{where}:{'.'.join(chain)}",
                message=f".join() under held lock [{held}] in {where}")
        if leaf == "wait" and len(chain) >= 2:
            # same-lock condition waits are the idiom; only foreign ones
            # (condition of a lock we don't hold) are deadlock-shaped
            underlying = None
            if chain[0] == "self" and len(chain) == 3:
                decl = cls.locks.get(chain[1])
                if decl is not None and decl.kind == "condition":
                    underlying = cls.lock_id(chain[1])
            if underlying is not None and underlying in call.held:
                return None
            return Finding(
                rule="BL004", severity=Severity.ERROR,
                path=cls.module, line=call.line,
                anchor=f"{where}:{'.'.join(chain)}",
                message=f".wait() on a condition not backed by the "
                        f"held lock [{held}] in {where}")
        return None

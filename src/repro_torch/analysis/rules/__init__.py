"""Rule interface and registry.

Every rule is one module exposing a subclass of :class:`Rule`; ``run``
yields :class:`Finding`s against a parsed :class:`Project`.  Codes are
stable and namespaced per rule family (LO/GB/BL/KL/RT/CH).
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import Project


class Rule:
    #: family prefix shared by this rule's finding codes, e.g. "LO"
    family: str = ""
    name: str = ""
    description: str = ""

    def run(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError


def _registry() -> List[Rule]:
    from repro_torch.analysis.rules.blocking_locked import BlockingWhileLocked
    from repro_torch.analysis.rules.chaos_coverage import ChaosCoverage
    from repro_torch.analysis.rules.guarded_by import GuardedByInference
    from repro_torch.analysis.rules.kernel_lint import KernelLint
    from repro_torch.analysis.rules.lock_order import LockOrder
    from repro_torch.analysis.rules.round_trip import RoundTripCompleteness
    return [LockOrder(), GuardedByInference(), BlockingWhileLocked(),
            KernelLint(), RoundTripCompleteness(), ChaosCoverage()]


ALL_RULES: List[Rule] = _registry()


def run_rules(project: Project,
              families: Optional[Sequence[str]] = None) -> List[Finding]:
    out: List[Finding] = []
    for rule in ALL_RULES:
        if families and rule.family not in families:
            continue
        out.extend(rule.run(project))
    # one finding per id: rules anchor on structure, so duplicates are
    # repeats of the same fact at different lines — keep the first
    seen = set()
    uniq = []
    for f in sorted(out, key=lambda f: (f.id, f.line)):
        if f.id not in seen:
            seen.add(f.id)
            uniq.append(f)
    return uniq


def rule_catalog() -> List[dict]:
    return [{"family": r.family, "name": r.name,
             "description": r.description} for r in ALL_RULES]

"""Repo-specific static analysis for the PyTorch/CUDA port.

Walks the ``repro_torch`` package with stdlib :mod:`ast` (it imports
neither torch nor anything of the reference package) and enforces the
concurrency/invariant rules the multi-threaded control plane depends on:
lock-order acyclicity, guarded-by discipline, no blocking calls under a
held lock, CUDA kernel-wrapper hygiene, dataclass round-trip
completeness and chaos recovery coverage.

Entry point: ``python -m repro_torch.analysis`` (see ``README.md`` in this
package for the rule catalog and baseline workflow).
"""
from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import Project
from repro_torch.analysis.rules import ALL_RULES, Rule, run_rules

__all__ = ["Finding", "Severity", "Project", "Rule", "ALL_RULES",
           "run_rules"]

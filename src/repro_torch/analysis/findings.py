"""Finding type shared by every rule.

A finding's identity is ``{rule}:{path}:{anchor}`` — deliberately free of
line numbers so baselines survive unrelated edits that shift lines.  The
anchor is rule-specific but always derived from stable program structure
(class/field/method names, lock ids, kernel function names).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "LO001"
    severity: str      # Severity.*
    path: str          # analysis-root-relative posix path
    line: int          # 1-based; informational only, not part of the id
    anchor: str        # stable structural anchor, e.g. "Cls.field@method"
    message: str

    @property
    def id(self) -> str:
        return f"{self.rule}:{self.path}:{self.anchor}"

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "anchor": self.anchor,
            "message": self.message,
        }


def sort_key(f: Finding):
    return (Severity.ORDER.get(f.severity, 9), f.rule, f.path, f.line,
            f.anchor)


def format_text(f: Finding, verbose: bool = False) -> str:
    loc = f"{f.path}:{f.line}"
    base = f"{f.severity:<7} {f.rule} {loc:<40} {f.message}"
    if verbose:
        base += f"\n        id: {f.id}"
    return base


@dataclasses.dataclass(frozen=True)
class Pragma:
    """An ``# analysis: <directive>`` comment attached to a source line."""
    directive: str           # e.g. "unguarded-ok", "oracle=mha", "derived"
    line: int

    @property
    def key(self) -> str:
        return self.directive.split("=", 1)[0]

    @property
    def value(self) -> Optional[str]:
        parts = self.directive.split("=", 1)
        return parts[1] if len(parts) == 2 else None

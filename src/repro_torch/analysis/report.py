"""Text and JSON reporting for the analyzer CLI."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding, format_text, sort_key
from repro_torch.analysis.rules import rule_catalog

REPORT_VERSION = 1


def render_text(new: List[Finding], known: List[Finding],
                stale: List[str], elapsed_s: float,
                n_modules: int) -> str:
    lines: List[str] = []
    for f in sorted(new, key=sort_key):
        lines.append(format_text(f))
    if new:
        lines.append("")
    lines.append(f"{n_modules} modules analyzed in {elapsed_s:.2f}s: "
                 f"{len(new)} new finding(s), {len(known)} baselined")
    if known:
        by_rule: Dict[str, int] = {}
        for f in known:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        lines.append("  baselined: " + ", ".join(
            f"{r}x{n}" for r, n in sorted(by_rule.items())))
    if stale:
        lines.append(f"  stale baseline entries (no longer firing, "
                     f"prune them): {len(stale)}")
        for sid in stale:
            lines.append(f"    {sid}")
    return "\n".join(lines)


def render_json(new: List[Finding], known: List[Finding],
                stale: List[str], elapsed_s: float, n_modules: int,
                lock_graph: Optional[dict] = None,
                kernel_wrappers: Optional[list] = None) -> dict:
    return {
        "version": REPORT_VERSION,
        "elapsed_s": round(elapsed_s, 3),
        "modules": n_modules,
        "rules": rule_catalog(),
        "new": [f.to_dict() for f in sorted(new, key=sort_key)],
        "baselined": [f.to_dict() for f in sorted(known, key=sort_key)],
        "stale_baseline": stale,
        **({"lock_graph": lock_graph} if lock_graph is not None else {}),
        **({"kernel_wrappers": [
            {"path": path, "name": name, "line": line}
            for path, name, line in kernel_wrappers]}
           if kernel_wrappers is not None else {}),
    }


def write_json(path, payload: dict) -> None:
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")

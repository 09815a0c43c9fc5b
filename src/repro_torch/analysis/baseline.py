"""Baseline (suppression) file handling.

The baseline is a checked-in JSON map of finding id → short note.  A
finding whose id appears in the baseline is *known*: reported in the
summary but never fails ``--check``.  Ids carry no line numbers, so the
baseline survives unrelated edits; it goes stale only when the anchored
structure itself changes — stale entries are reported so they get pruned.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_VERSION = 1


def load_baseline(path) -> Dict[str, dict]:
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    if data.get("version") != BASELINE_VERSION:
        return {}
    return dict(data.get("findings", {}))


def write_baseline(path, findings: Iterable[Finding],
                   previous: Dict[str, dict]) -> Dict[str, dict]:
    """Persist current findings as the new baseline, keeping notes from
    ``previous`` for ids that survive."""
    entries = {}
    for f in sorted(findings, key=lambda f: f.id):
        kept = previous.get(f.id, {})
        entries[f.id] = {
            "rule": f.rule,
            "note": kept.get("note", "TODO: justify or fix"),
        }
    data = {"version": BASELINE_VERSION, "findings": entries}
    Path(path).write_text(json.dumps(data, indent=2, sort_keys=True)
                          + "\n")
    return entries


def diff_findings(findings: List[Finding], baseline: Dict[str, dict]) \
        -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, known, stale-baseline-ids)."""
    new, known = [], []
    seen = set()
    for f in findings:
        seen.add(f.id)
        (known if f.id in baseline else new).append(f)
    stale = sorted(set(baseline) - seen)
    return new, known, stale

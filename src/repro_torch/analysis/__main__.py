"""``python -m repro_torch.analysis`` — run the static-analysis pass.

Analyses ``src/repro_torch`` unless ``--root`` names another tree.  When
the KL family runs, the report names the kernel wrappers it found (the
text's last line, the JSON's ``kernel_wrappers``): a lint that finds no
wrapper checks nothing.

Exit codes: 0 clean (or all findings baselined), 1 new findings with
``--check``, 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.analysis.baseline import (diff_findings, load_baseline,
                                     write_baseline)
from repro_torch.analysis.project import Project
from repro_torch.analysis.report import render_json, render_text, write_json
from repro_torch.analysis.rules import ALL_RULES, run_rules
from repro_torch.analysis.rules.kernel_lint import kernel_wrappers
from repro_torch.analysis.rules.lock_order import build_lock_graph


def default_root() -> Path:
    """The ``repro_torch`` package this analyzer ships in (found by path:
    importing the package's modules would import torch)."""
    return Path(__file__).resolve().parent.parent


def analyze(root, families=None):
    """Parse ``root`` and run the rules; returns (project, findings)."""
    project = Project(Path(root))
    return project, run_rules(project, families=families)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific concurrency/invariant static analysis")
    ap.add_argument("--root", default=None,
                    help="package root to analyze (default: the "
                         "installed repro_torch package)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families to run "
                         f"(default all: "
                         f"{','.join(r.family for r in ALL_RULES)})")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON; findings listed there are "
                         "known and never fail --check")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when any non-baselined finding fires")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from the current findings "
                         "(keeps existing notes)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a JSON report (includes the lock "
                         "graph)")
    args = ap.parse_args(argv)

    families = None
    if args.rules:
        families = [f.strip().upper() for f in args.rules.split(",")
                    if f.strip()]
        valid = {r.family for r in ALL_RULES}
        bad = set(families) - valid
        if bad:
            print(f"unknown rule families: {sorted(bad)} "
                  f"(valid: {sorted(valid)})", file=sys.stderr)
            return 2
    if args.update_baseline and not args.baseline:
        print("--update-baseline requires --baseline", file=sys.stderr)
        return 2

    root = Path(args.root) if args.root else default_root()
    if not root.is_dir():
        print(f"not a directory: {root}", file=sys.stderr)
        return 2

    t0 = time.monotonic()
    project, findings = analyze(root, families)
    elapsed = time.monotonic() - t0

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, known, stale = diff_findings(findings, baseline)

    if args.update_baseline:
        write_baseline(args.baseline, findings, baseline)
        print(f"baseline updated: {args.baseline} "
              f"({len(findings)} entries)")
        return 0

    wrappers = kernel_wrappers(project) \
        if families is None or "KL" in families else None
    text = render_text(new, known, stale, elapsed, len(project.modules))
    if wrappers is not None:
        text += (f"\n  kernel wrappers (KL): {len(wrappers)}: "
                 + ", ".join(name for _, name, _ in wrappers))
    print(text)
    if args.json:
        graph = {"edges": [
            {"src": src, "dst": dst,
             "evidence": [f"{w} ({m}:{ln})" for m, w, ln in ev]}
            for (src, dst), ev in sorted(
                build_lock_graph(project).items())]}
        write_json(args.json, render_json(
            new, known, stale, elapsed, len(project.modules),
            lock_graph=graph, kernel_wrappers=wrappers))

    if args.check and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

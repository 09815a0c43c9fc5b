"""Per-scenario SLO scorecards; the port of ``repro.harness.scorecard``.

A scorecard condenses one ``ReplayReport`` into the numbers the repo's
perf trajectory is tracked on: SLO attainment, latency percentiles,
goodput (SLO-met completions per wall second), admission outcomes,
preemption/failover counts from the orchestrator event stream, Jain
fairness and intra-QoS-class tenant skew (the weighted-fair-dispatch
bound), GUARANTEED-class accounting (completed / requeued / dropped —
the chaos invariant), and every chaos record with its measured recovery.

``write_scorecards`` merges scenarios into a versioned envelope so
successive runs append comparable rows instead of overwriting history
shape.  The default envelope is ``build/port_traces.json`` (the JAX
package's default is ``BENCH_traces.json``, which the port never
writes).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.core.telemetry import percentile
from repro_torch.harness.replay import ReplayReport, RequestOutcome

SCORECARD_VERSION = 1
DEFAULT_PATH = os.path.join("build", "port_traces.json")

EVENT_COUNTERS = ("preempt", "requeue", "failover", "failover-FAILED",
                  "redeploy", "reconcile")


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index over positive per-tenant aggregates; 1.0 is
    perfectly fair, 1/n is maximally skewed."""
    xs = [v for v in values if v > 0 and math.isfinite(v)]
    if not xs:
        return float("nan")
    return sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs))


def _latency_block(outcomes: List[RequestOutcome]) -> Dict[str, float]:
    lats = [o.latency_s for o in outcomes if o.ok]
    if not lats:
        return {}
    out = {"mean_s": round(sum(lats) / len(lats), 6)}
    for q in (50, 95, 99):
        out[f"p{q}_s"] = round(percentile(lats, q), 6)
    return out


def _tenant_block(outcomes: List[RequestOutcome]) -> Dict[str, dict]:
    tenants = sorted({o.tenant for o in outcomes})
    out = {}
    for t in tenants:
        sub = [o for o in outcomes if o.tenant == t]
        with_slo = [o for o in sub if o.slo_ms > 0]
        out[t] = {
            "count": len(sub),
            "completed": sum(1 for o in sub if o.ok),
            **_latency_block(sub),
            "slo_attainment": round(
                sum(1 for o in sub if o.slo_met) / len(sub), 4),
            "qos": sorted({o.qos for o in sub}),
            "with_slo": len(with_slo),
        }
    return out


def _intra_class_skew(outcomes: List[RequestOutcome]) -> Dict[str, float]:
    """Per-QoS-class max/min ratio of per-tenant mean latency — the skew
    weighted fair dispatch bounds.  Classes with one tenant report 1.0."""
    out = {}
    for qos in sorted({o.qos for o in outcomes}):
        means = []
        for t in sorted({o.tenant for o in outcomes if o.qos == qos}):
            lats = [o.latency_s for o in outcomes
                    if o.qos == qos and o.tenant == t and o.ok]
            if lats:
                means.append(sum(lats) / len(lats))
        if not means:
            continue
        out[qos] = round(max(means) / min(means), 4) if min(means) > 0 \
            else float("nan")
    return out


def build_scorecard(report: ReplayReport,
                    extra: Optional[Dict[str, object]] = None) -> dict:
    """One scenario's scorecard from its replay report."""
    outcomes = report.outcomes
    counts = report.counts()
    met = sum(1 for o in outcomes if o.slo_met)
    guaranteed = [o for o in outcomes if o.qos == "guaranteed"]
    g_completed = sum(1 for o in guaranteed if o.ok)
    g_requeued = sum(1 for o in guaranteed if o.requeues)
    # the chaos invariant is "completed or requeued, never *silently*
    # dropped": a request that exhausted its requeues is a recorded
    # failure, not a drop; a drop is one that neither completed nor was
    # ever retried (e.g. hung past the drain timeout)
    g_failed = sum(1 for o in guaranteed if not o.ok and o.requeues)
    g_dropped = sum(1 for o in guaranteed if not o.ok and not o.requeues)
    events = {k: sum(1 for e in report.events
                     if e.startswith(k + " ") or e.startswith(k))
              for k in EVENT_COUNTERS}
    # prefixes nest ("failover" counts "failover-FAILED" too) — disentangle
    events["failover"] -= events["failover-FAILED"]
    tenant_means = []
    for t in sorted({o.tenant for o in outcomes}):
        lats = [o.latency_s for o in outcomes if o.tenant == t and o.ok]
        if lats:
            tenant_means.append(sum(lats) / len(lats))
    card = {
        "trace": report.trace_name,
        "seed": report.seed,
        "duration_s": round(report.duration_s, 3),
        "speed": report.speed,
        "wall_s": round(report.wall_s, 3),
        "requests": counts,
        "latency": _latency_block(outcomes),
        "queue": {"p95_s": round(percentile(
            [o.queue_s for o in outcomes if o.ok], 95), 6)}
        if any(o.ok for o in outcomes) else {},
        "slo": {
            "attainment": round(met / len(outcomes), 4) if outcomes
            else float("nan"),
            "met": met,
            "with_slo": sum(1 for o in outcomes if o.slo_ms > 0),
        },
        "goodput_rps": round(met / report.wall_s, 3)
        if report.wall_s > 0 else float("nan"),
        "per_tenant": _tenant_block(outcomes),
        "fairness": {
            "jain_latency": round(jain_index(tenant_means), 4),
            "intra_class_skew": _intra_class_skew(outcomes),
        },
        "events": events,
        "guaranteed": {
            "total": len(guaranteed),
            "completed": g_completed,
            "requeued": g_requeued,
            "failed_after_requeue": g_failed,
            "dropped": g_dropped,
        },
        "chaos": [r.to_dict() for r in report.chaos],
    }
    if extra:
        card.update(extra)
    return card


# --------------------------------------------------------------------------
# persistence
# --------------------------------------------------------------------------

def diff_scorecards(old: dict, new: dict, *,
                    attainment_drop: float = 0.05,
                    p95_ratio: float = 2.0,
                    p95_slack_s: float = 0.05) -> List[str]:
    """Regressions between two scorecard envelopes, as human-readable
    strings (empty list = no regression).

    Only scenarios present in *both* envelopes are compared (a fresh
    canary run writes one scenario; the committed file carries the full
    history).  Tolerances are deliberately generous: sim service times
    are ms-scale and CI runners are noisy, so p95 gets a ratio *and* an
    absolute slack — a genuine scheduling regression (dense blocking,
    lost failover) shows up in the hundreds of ms and still trips it.
    """
    regressions: List[str] = []
    old_sc = old.get("scenarios", {})
    new_sc = new.get("scenarios", {})
    for name in sorted(set(old_sc) & set(new_sc)):
        o, n = old_sc[name], new_sc[name]
        o_att = o.get("slo", {}).get("attainment")
        n_att = n.get("slo", {}).get("attainment")
        if o_att is not None and n_att is not None and \
                n_att < o_att - attainment_drop:
            regressions.append(
                f"{name}: SLO attainment {n_att:.4f} fell more than "
                f"{attainment_drop} below previous {o_att:.4f}")
        o_p95 = o.get("latency", {}).get("p95_s")
        n_p95 = n.get("latency", {}).get("p95_s")
        if o_p95 is not None and n_p95 is not None and \
                n_p95 > o_p95 * p95_ratio + p95_slack_s:
            regressions.append(
                f"{name}: p95 {n_p95 * 1e3:.2f}ms exceeds "
                f"{p95_ratio}x previous ({o_p95 * 1e3:.2f}ms) + "
                f"{p95_slack_s * 1e3:.0f}ms slack")
        o_drop = o.get("guaranteed", {}).get("dropped", 0)
        n_drop = n.get("guaranteed", {}).get("dropped", 0)
        if n_drop > o_drop:
            regressions.append(
                f"{name}: GUARANTEED drops grew {o_drop} -> {n_drop}")
    return regressions


def load_scorecards(path: str = DEFAULT_PATH) -> dict:
    if not os.path.exists(path):
        return {"version": SCORECARD_VERSION, "scenarios": {}}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != SCORECARD_VERSION:
        # unknown shape: start a fresh envelope rather than corrupt it
        return {"version": SCORECARD_VERSION, "scenarios": {}}
    data.setdefault("scenarios", {})
    return data


def write_scorecards(cards: Dict[str, dict],
                     path: str = DEFAULT_PATH) -> dict:
    """Merge ``{scenario: scorecard}`` into the persisted envelope
    (atomic replace; existing scenarios not in ``cards`` survive)."""
    data = load_scorecards(path)
    data["scenarios"].update(cards)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return data


def main(argv=None) -> int:
    """``python -m repro_torch.harness.scorecard`` — scorecard diff gate.

    Compares two envelopes scenario-by-scenario and exits 1 on any
    attainment/p95/GUARANTEED-drop regression beyond tolerance."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.harness.scorecard",
        description="diff two scorecard envelopes")
    ap.add_argument("--old", required=True,
                    help="previous (committed) envelope")
    ap.add_argument("--new", required=True, help="fresh envelope")
    ap.add_argument("--attainment-drop", type=float, default=0.05)
    ap.add_argument("--p95-ratio", type=float, default=2.0)
    ap.add_argument("--p95-slack-s", type=float, default=0.05)
    args = ap.parse_args(argv)
    old = load_scorecards(args.old)
    new = load_scorecards(args.new)
    shared = sorted(set(old.get("scenarios", {})) &
                    set(new.get("scenarios", {})))
    if not shared:
        print("scorecard-diff: no shared scenarios to compare",
              file=sys.stderr)
        return 1
    regressions = diff_scorecards(
        old, new, attainment_drop=args.attainment_drop,
        p95_ratio=args.p95_ratio, p95_slack_s=args.p95_slack_s)
    for r in regressions:
        print(f"REGRESSION {r}")
    print(f"scorecard-diff: {len(shared)} scenario(s) compared "
          f"({', '.join(shared)}), {len(regressions)} regression(s)")
    return 1 if regressions else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

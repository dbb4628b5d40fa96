#!/usr/bin/env python
"""One-shot terminal dashboard over the embedded TSDB.

A copy of the reference's tools/dashboard.py (stdlib only). Renders a
format-1 timeseries snapshot (MetricsSampler.snapshot_doc()) as sparkline
rows for every recording rule, a per-replica column table (federated
``replica``-labelled series, frozen members flagged), and, when a loadgen
run report is supplied alongside, the current SLO verdicts. ``--json``
emits the same content machine-readable.

Usage:
  python3 -m paddle_tpu_torch.tools.loadgen --scenario chat --seed 0 \
          --dashboard                # end-of-run dashboard on stderr
  python3 -m paddle_tpu_torch.tools.loadgen ... --out report.json
  python3 -m paddle_tpu_torch.tools.dashboard report.json
          # offline, from the report's timeline (the TSDB summary has no
          # raw points)
  python3 -m paddle_tpu_torch.tools.dashboard tsdb_snapshot.json
  python3 -m paddle_tpu_torch.tools.dashboard report.json --json
"""

from __future__ import annotations

import argparse
import json
import sys

SPARK = " ▁▂▃▄▅▆▇█"


def sparkline(values, width=32):
    """Unicode block sparkline of the LAST `width` values."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return SPARK[1] * len(vals)
    steps = len(SPARK) - 1
    return "".join(
        SPARK[1 + int((v - lo) / span * (steps - 1))] for v in vals)


def _is_tsdb(doc):
    return isinstance(doc, dict) and doc.get("format") == 1 \
        and "series" in doc


def _rule_rows_from_tsdb(doc):
    """rule name -> list of values (mesh-level rule/ series only)."""
    rows = {}
    for s in doc.get("series", ()):
        name = s.get("name", "")
        if not name.startswith("rule/") or (s.get("labels") or {}):
            continue
        rows[name[len("rule/"):]] = [v for _t, v in s.get("points", ())]
    return rows


def _rule_rows_from_report(report):
    """Offline fallback: a loadgen report carries only the TSDB summary
    (latest values), so sparklines come from the report's timeline where
    a rule has a timeline analogue."""
    timeline = report.get("timeline") or []
    analogues = {
        "goodput_rate": [p.get("good") for p in timeline],
        "shed_fraction": [p.get("shed_frac") for p in timeline],
        "headroom_min": [p.get("headroom") for p in timeline],
        "brownout_max": [p.get("brownout") for p in timeline],
    }
    rows = {}
    rules = ((report.get("timeseries") or {}).get("rules") or {})
    for name, info in rules.items():
        vals = [v for v in analogues.get(name, ()) if v is not None]
        if not vals and info.get("latest") is not None:
            vals = [info["latest"]]
        rows[name] = vals
    return rows


def _replica_table(doc):
    """replica label -> {series tail values} from a merged federation
    doc (empty for single-engine snapshots)."""
    reps = {}
    for s in doc.get("series", ()) if _is_tsdb(doc) else ():
        lab = (s.get("labels") or {}).get("replica")
        if lab is None:
            continue
        pts = s.get("points", ())
        if not pts:
            continue
        reps.setdefault(lab, {})[s["name"]] = pts[-1][1]
    frozen = set(doc.get("frozen", ())) if _is_tsdb(doc) else set()
    out = {}
    for lab in sorted(reps):
        row = reps[lab]
        out[lab] = {
            "state": "frozen" if lab in frozen else "live",
            "load": row.get("replica_load"),
            "predicted_service_s":
                row.get("replica_predicted_service_seconds"),
            "routed_rate": row.get("replica_routed_total"),
            "tokens_rate": row.get("replica_tokens_total"),
        }
    return out


def build(doc, report=None):
    """-> machine-readable dashboard dict (the --json payload)."""
    if _is_tsdb(doc):
        rules = _rule_rows_from_tsdb(doc)
        if not rules and report is not None:
            rules = _rule_rows_from_report(report)
    else:
        report = doc if report is None else report
        rules = _rule_rows_from_report(doc)
    slo = (report or {}).get("slo") if isinstance(report, dict) else None
    auto = (((report or {}).get("mesh") or {}).get("autoscale")
            if isinstance(report, dict) else None)
    return {
        "format": 1,
        "rules": {name: {"latest": vals[-1] if vals else None,
                         "points": len(vals), "values": vals}
                  for name, vals in sorted(rules.items())},
        "replicas": _replica_table(doc),
        "slo": slo,
        "autoscale": auto,
    }


def render(doc, report=None, width=32):
    """-> the human terminal dashboard as one string."""
    dash = build(doc, report=report)
    lines = ["== observability dashboard =="]
    lines.append(f"{'rule':16s} {'latest':>12s}  trend")
    for name, row in dash["rules"].items():
        latest = row["latest"]
        shown = "-" if latest is None else f"{latest:.4g}"
        lines.append(f"{name:16s} {shown:>12s}  "
                     f"{sparkline(row['values'], width)}")
    if dash["replicas"]:
        lines.append("")
        lines.append(f"{'replica':10s} {'state':7s} {'load':>6s} "
                     f"{'svc_s':>8s} {'routed/s':>9s} {'tok/s':>8s}")
        for lab, row in dash["replicas"].items():
            def _f(v, nd=3):
                return "-" if v is None else f"{v:.{nd}g}"
            lines.append(f"{lab:10s} {row['state']:7s} "
                         f"{_f(row['load']):>6s} "
                         f"{_f(row['predicted_service_s']):>8s} "
                         f"{_f(row['routed_rate']):>9s} "
                         f"{_f(row['tokens_rate']):>8s}")
    slo = dash.get("slo")
    if isinstance(slo, dict) and slo.get("slos"):
        lines.append("")
        lines.append(f"SLO verdict: {'PASS' if slo.get('ok') else 'BREACH'}")
        for r in slo["slos"]:
            state = "ok" if r.get("ok") else "BREACH"
            obs = r.get("observed")
            shown = "-" if obs is None else f"{obs:.4g}"
            lines.append(f"  {r.get('name', '?'):24s} {state:6s} "
                         f"observed={shown} objective="
                         f"{r.get('objective')} burn="
                         f"{round(r.get('burn_rate', 0.0), 3)}")
    auto = dash.get("autoscale")
    if isinstance(auto, dict):
        lines.append("")
        lines.append(
            f"autoscale: {auto.get('action')} -> desired="
            f"{auto.get('desired_replicas')} (current="
            f"{auto.get('current_replicas')}, {auto.get('reason')})")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="loadgen report JSON or a format-1 "
                    "TSDB snapshot / merged federation doc")
    ap.add_argument("--json", action="store_true",
                    help="emit the dashboard machine-readable")
    ap.add_argument("--width", type=int, default=32,
                    help="sparkline width (last N points)")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        doc = json.load(f)
    report = doc if not _is_tsdb(doc) else None
    if args.json:
        print(json.dumps(build(doc, report=report), indent=1,
                         default=str))
    else:
        print(render(doc, report=report, width=args.width))
    return 0


if __name__ == "__main__":
    sys.exit(main())

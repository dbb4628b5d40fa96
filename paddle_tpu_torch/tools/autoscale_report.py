#!/usr/bin/env python
"""Autoscale signal exporter CLI: extract (or recompute) the mesh's
machine-readable autoscale verdict for an external replica controller.

reference: tools/autoscale_report.py.

Usage:
  python3 -m paddle_tpu_torch.tools.loadgen --scenario chat --replicas 2 \\
          --out report.json
  python3 -m paddle_tpu_torch.tools.autoscale_report report.json
          # human verdict
  python3 -m paddle_tpu_torch.tools.autoscale_report report.json --json
          # the raw format-1 verdict a controller consumes
          (OBSERVABILITY.md "Autoscale runbook")
  python3 -m paddle_tpu_torch.tools.autoscale_report report.json --check
          # exit nonzero unless the verdict is present and internally
          consistent
          (autoscale.check_verdict: format, action/desired coherence,
          hysteresis state, signals, drain predictions)

Input is a loadgen run report whose mesh block embeds the verdict
(MeshRouter.mesh_report()["autoscale"]). With --replay, the verdict is
recomputed offline by replaying the report's timeline headroom samples
through a fresh AutoscaleAdvisor — the determinism cross-check that an
external controller driving the same series would reach the same
advice.
"""

from __future__ import annotations

import argparse
import json
import sys

from paddle_tpu_torch.observability.autoscale import (AutoscaleAdvisor,
                                                      check_verdict)


def replay_verdict(report):
    """Recompute a verdict from the report's timeline (headroom series
    + backlog) — deterministic: same report, same verdict."""
    mesh = report.get("mesh") or {}
    replicas = mesh.get("replicas") or {}
    current = sum(1 for r in replicas.values() if r.get("alive")) \
        or max(1, len(replicas))
    adv = AutoscaleAdvisor()
    verdict = None
    for point in report.get("timeline") or [{}]:
        head = point.get("headroom")
        verdict = adv.advise(
            current_replicas=current,
            headroom_min=1.0 if head is None else float(head),
            backlog=max(0, int(point.get("issued", 0))
                        - int(point.get("finished", 0))
                        - int(point.get("rejected", 0))),
            replica_stats=replicas)
    return verdict


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="loadgen run report JSON (mesh run)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw format-1 verdict")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless the verdict is present "
                         "and internally consistent")
    ap.add_argument("--replay", action="store_true",
                    help="recompute the verdict offline from the "
                         "report's timeline instead of reading the "
                         "embedded one")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        report = json.load(f)

    if args.replay:
        verdict = replay_verdict(report)
    else:
        verdict = (report.get("mesh") or {}).get("autoscale")

    if verdict is None:
        print("no autoscale verdict (single-engine run, plane off, or "
              "--replay on a report without a timeline)", file=sys.stderr)
        return 1 if args.check else 0

    if args.json:
        print(json.dumps(verdict, indent=1, default=str))
    else:
        sig = verdict.get("signals") or {}
        hyst = verdict.get("hysteresis") or {}
        print(f"autoscale verdict (format {verdict.get('format')}):")
        print(f"  action            {verdict.get('action')} "
              f"(proposal {verdict.get('proposal')}: "
              f"{verdict.get('reason')})")
        print(f"  replicas          {verdict.get('current_replicas')} -> "
              f"desired {verdict.get('desired_replicas')}")
        print(f"  signals           headroom_min="
              f"{sig.get('headroom_min')} headroom_sum="
              f"{sig.get('headroom_sum')} burn={sig.get('burn_rate')} "
              f"backlog={sig.get('backlog')}")
        print(f"  hysteresis        {hyst.get('streak')}/"
              f"{hyst.get('needed')} ticks toward "
              f"{hyst.get('pending')!r}")
        drain = verdict.get("drain_s") or {}
        for name, secs in sorted(drain.items()):
            print(f"  drain {name:12s} {secs}s predicted to empty")

    if args.check:
        problems = check_verdict(verdict)
        for p in problems:
            print(f"CHECK FAIL: {p}", file=sys.stderr)
        if problems:
            return 1
        print("CHECK PASS: autoscale verdict well-formed and "
              "internally consistent", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Deterministic autoscale advisor: headroom/backlog/burn-rate series
in, a machine-readable format-1 scaling verdict out.

This is the consumer the ROADMAP autoscale item named: "autoscale
signals derived from predicted_service_seconds() exported for an
external replica controller". The advisor never acts — it emits a
verdict from ``mesh_report()`` (and ``tools/autoscale_report.py``
offline) that an external controller can apply. It is deterministic
(no wall clock, no randomness: the same signal sequence always yields
the same verdict sequence) and hysteresis-damped so advice cannot flap
on a threshold boundary.

Verdict (format 1)::

    {"format": 1,
     "action": "scale_up" | "scale_down" | "hold",   # committed
     "proposal": ...,          # this tick's raw lean, pre-hysteresis
     "reason": "...",
     "current_replicas": n, "desired_replicas": n,
     "signals": {"headroom_min": x, "headroom_sum": x,
                 "burn_rate": x, "backlog": n},
     "hysteresis": {"pending": action, "streak": n, "needed": n},
     "drain_s": {replica: predicted_seconds_to_drain, ...}}

Scaling logic: scale UP when the tightest alive replica's headroom is
below ``scale_up_headroom`` or any SLO burns its error budget faster
than ``burn_limit``; scale DOWN only when every replica has at least
``scale_down_headroom`` spare, the mesh's summed headroom could absorb
losing a whole replica (>= 1 + scale_down_headroom), and nothing is
queued. A proposal must persist ``hysteresis_ticks`` consecutive
advise() calls before it commits into ``desired_replicas``.

Port: a copy of `paddle_tpu/observability/autoscale.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

__all__ = ["AutoscaleAdvisor", "VERDICT_FORMAT", "check_verdict"]

VERDICT_FORMAT = 1

_ACTIONS = ("scale_up", "hold", "scale_down")


class AutoscaleAdvisor:
    def __init__(self, scale_up_headroom=0.1, scale_down_headroom=0.5,
                 min_replicas=1, max_replicas=16, hysteresis_ticks=3,
                 burn_limit=1.0):
        self.scale_up_headroom = float(scale_up_headroom)
        self.scale_down_headroom = float(scale_down_headroom)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.hysteresis_ticks = max(1, int(hysteresis_ticks))
        self.burn_limit = float(burn_limit)
        self._pending = "hold"
        self._streak = 0
        self._desired = None

    def _propose(self, current, headroom_min, headroom_sum, burn_rate,
                 backlog):
        if current < self.min_replicas:
            return "scale_up", (f"current {current} < min_replicas "
                                f"{self.min_replicas}")
        if headroom_min < self.scale_up_headroom and \
                current < self.max_replicas:
            return "scale_up", (f"headroom_min {headroom_min:.3f} < "
                                f"{self.scale_up_headroom:.3f}")
        if burn_rate > self.burn_limit and current < self.max_replicas:
            return "scale_up", (f"slo burn rate {burn_rate:.2f} > "
                                f"{self.burn_limit:.2f}")
        if (current > self.min_replicas and backlog == 0
                and headroom_min > self.scale_down_headroom
                and headroom_sum >= 1.0 + self.scale_down_headroom):
            return "scale_down", (f"headroom_sum {headroom_sum:.3f} "
                                  "absorbs losing one replica")
        return "hold", "within bounds"

    def advise(self, *, current_replicas, headroom_min=1.0,
               headroom_sum=None, burn_rate=0.0, backlog=0,
               replica_stats=None):
        """One deterministic advisory tick. ``replica_stats`` maps
        replica name -> Replica.snapshot()-shaped dict; per-replica
        drain predictions are load x predicted_service_s from it."""
        current = max(0, int(current_replicas))
        headroom_min = float(headroom_min)
        if headroom_sum is None:
            headroom_sum = headroom_min * max(1, current)
        headroom_sum = float(headroom_sum)
        burn_rate = float(burn_rate)
        backlog = max(0, int(backlog))

        proposal, reason = self._propose(current, headroom_min,
                                         headroom_sum, burn_rate, backlog)
        if proposal == self._pending:
            self._streak += 1
        else:
            self._pending = proposal
            self._streak = 1

        action = "hold"
        if proposal != "hold" and self._streak >= self.hysteresis_ticks:
            action = proposal
        if action == "scale_up":
            self._desired = min(self.max_replicas,
                                max(current + 1, self.min_replicas))
        elif action == "scale_down":
            self._desired = max(self.min_replicas, current - 1)
        else:
            self._desired = min(self.max_replicas,
                                max(current, self.min_replicas))

        drain = {}
        for name, st in sorted((replica_stats or {}).items()):
            load = float(st.get("load") or 0.0)
            svc = float(st.get("predicted_service_s") or 0.0)
            drain[name] = round(load * svc, 6)

        return {
            "format": VERDICT_FORMAT,
            "action": action,
            "proposal": proposal,
            "reason": reason,
            "current_replicas": current,
            "desired_replicas": int(self._desired),
            "signals": {"headroom_min": headroom_min,
                        "headroom_sum": headroom_sum,
                        "burn_rate": burn_rate,
                        "backlog": backlog},
            "hysteresis": {"pending": self._pending,
                           "streak": self._streak,
                           "needed": self.hysteresis_ticks},
            "drain_s": drain,
        }


def check_verdict(verdict):
    """-> list of problem strings (empty = verdict is well-formed and
    internally consistent). The --check gates in tools/loadgen.py and
    tools/autoscale_report.py both call this — one checker."""
    problems = []
    if not isinstance(verdict, dict):
        return [f"autoscale verdict is {type(verdict).__name__}, not dict"]
    if verdict.get("format") != VERDICT_FORMAT:
        problems.append(f"verdict format {verdict.get('format')!r} != "
                        f"{VERDICT_FORMAT}")
    action = verdict.get("action")
    if action not in _ACTIONS:
        problems.append(f"unknown action {action!r}")
    if verdict.get("proposal") not in _ACTIONS:
        problems.append(f"unknown proposal {verdict.get('proposal')!r}")
    desired = verdict.get("desired_replicas")
    current = verdict.get("current_replicas")
    if not isinstance(desired, int) or desired < 1:
        problems.append(f"desired_replicas {desired!r} must be an int >= 1")
    if not isinstance(current, int) or current < 0:
        problems.append(f"current_replicas {current!r} must be an int >= 0")
    if isinstance(desired, int) and isinstance(current, int):
        if action == "scale_up" and desired < current:
            problems.append("action scale_up but desired < current")
        if action == "scale_down" and desired > current:
            problems.append("action scale_down but desired > current")
        if abs(desired - current) > 1:
            problems.append("desired moved more than one replica in one "
                            "verdict (advice must be incremental)")
    hyst = verdict.get("hysteresis")
    if not isinstance(hyst, dict) or not all(
            k in hyst for k in ("pending", "streak", "needed")):
        problems.append("hysteresis state missing pending/streak/needed")
    elif action != "hold" and hyst["streak"] < hyst["needed"]:
        problems.append("committed action with streak below the "
                        "hysteresis threshold")
    sig = verdict.get("signals")
    if not isinstance(sig, dict) or not all(
            k in sig for k in ("headroom_min", "headroom_sum",
                               "burn_rate", "backlog")):
        problems.append("signals missing headroom_min/headroom_sum/"
                        "burn_rate/backlog")
    if not isinstance(verdict.get("drain_s"), dict):
        problems.append("drain_s per-replica predictions missing")
    return problems

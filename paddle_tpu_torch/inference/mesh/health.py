"""Progress-scored replica health for the serving mesh.

A crash-only failure model misses the failures a real fleet hits most:
workers that are alive-but-wrong — wedged in a step, paused by the OS,
behind a saturated NIC. The transport's typed timeouts make those waits
BOUNDED; this module decides what they MEAN, from the one signal that
cannot lie: progress.

`HealthDetector` keeps a phi-accrual-style suspicion score per replica
(Hayashibara et al.'s accrual detector, the Cassandra/Akka lineage):
every pump the router reports whether the replica is busy and a tuple of
its progress counters (steps, harvested streams, tokens). While a BUSY
replica's counters move, inter-progress intervals feed a per-replica
window and suspicion stays 0. When the counters stop moving, suspicion
phi = elapsed / (mean_interval * ln 10) grows continuously — phi = 3
means "this silence is ~10^3 times past plausible". Two thresholds
yield three verdicts:

  healthy  -> normal ranking
  slow     -> demoted out of `_ranked` (no NEW placements; existing
              streams keep running and the hedger covers them) —
              counted mesh_slow_demotions_total, reversible the moment
              progress resumes
  dead     -> the existing replica_down path (tombstone + breaker slam
              + re-prefill on survivors)

Elapsed-time floors (slow_elapsed_s / dead_elapsed_s) gate both
verdicts so a fast replica with microsecond intervals cannot be killed
by one scheduling hiccup: a verdict needs the score AND real wall
silence. An idle replica is never suspect — no work owed, no expected
progress.

`LatencyBudget` is the hedging trigger: observed placed->commit service
times on fixed geometric buckets, read back through THE shared
estimator (`observability/quantiles.quantile_from_cumulative` — the
same code SLO verdicts use, so "p95 service" can never mean two
things). budget() returns quantile * multiplier, or None until enough
samples landed to trust it.

Port: a copy of paddle_tpu/inference/mesh/health.py, which imports no
JAX; its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import math
from collections import deque

from ...observability.quantiles import quantile_from_cumulative

__all__ = ["VERDICTS", "HealthDetector", "LatencyBudget"]

# the closed verdict registry (static_check closes mesh code and the
# RESILIENCE.md runbook over these keys, both directions)
VERDICTS = {
    "healthy": "progressing (or idle): full member of the routing rank",
    "slow": "busy without progress past the slow thresholds: demoted "
            "from new placements, hedged around, NOT killed — recovers "
            "the moment a progress counter moves",
    "dead": "busy without progress past the dead thresholds: handed to "
            "the replica_down path (tombstone, breaker slam, "
            "re-prefill on survivors)",
}

_LN10 = math.log(10.0)


class _Track:
    __slots__ = ("progress", "last_t", "busy", "intervals")

    def __init__(self, window):
        self.progress = None     # last progress tuple seen
        self.last_t = None       # when it last moved (or went idle)
        self.busy = False
        self.intervals = deque(maxlen=window)


class HealthDetector:
    """Per-replica suspicion scoring. observe() is called once per
    router pump per replica; it returns (verdict, phi) and keeps all
    state internally. forget() drops a replica (killed/retired) so a
    respawn under the same name starts clean."""

    def __init__(self, slow_phi=1.0, dead_phi=8.0, slow_elapsed_s=0.25,
                 dead_elapsed_s=2.0, window=32, floor_s=0.005,
                 prior_interval_s=0.25):
        self.slow_phi = float(slow_phi)
        self.dead_phi = float(dead_phi)
        self.slow_elapsed_s = float(slow_elapsed_s)
        self.dead_elapsed_s = float(dead_elapsed_s)
        self.window = int(window)
        self.floor_s = float(floor_s)
        # mean interval assumed before a replica's first observed
        # progress (a fresh replica that stalls immediately must still
        # accrue suspicion from SOMETHING)
        self.prior_interval_s = float(prior_interval_s)
        self._tracks = {}

    def forget(self, name):
        self._tracks.pop(name, None)

    def _mean_interval(self, st):
        if not st.intervals:
            return self.prior_interval_s
        return max(self.floor_s,
                   sum(st.intervals) / len(st.intervals))

    def suspicion(self, name, now):
        """Current phi for one replica (0.0 = no basis for suspicion)."""
        st = self._tracks.get(name)
        if st is None or st.last_t is None or not st.busy:
            return 0.0
        elapsed = max(0.0, now - st.last_t)
        return elapsed / (self._mean_interval(st) * _LN10)

    def observe(self, name, now, busy, progress):
        """One pump's report -> (verdict, phi). `progress` is any
        comparable tuple of monotone counters; ANY movement resets
        suspicion and (if the replica was busy) feeds the interval
        window."""
        st = self._tracks.get(name)
        if st is None:
            st = self._tracks[name] = _Track(self.window)
        if st.progress != progress:
            if st.last_t is not None and st.busy:
                st.intervals.append(max(self.floor_s, now - st.last_t))
            st.progress = progress
            st.last_t = now
        elif not busy:
            # idle: no work owed, no expected progress — the clock
            # only starts once work shows up again
            st.last_t = now
        elif st.last_t is None or not st.busy:
            # first work ever, or work arriving after an idle stretch:
            # the silence clock starts NOW — the idle gap itself is not
            # suspicion (without this, idle->busy scores the whole gap
            # and one pump can kill a freshly-loaded replica)
            st.last_t = now
        st.busy = bool(busy)
        phi = self.suspicion(name, now)
        verdict = "healthy"
        if st.busy:
            elapsed = now - st.last_t
            if elapsed >= self.slow_elapsed_s and phi >= self.slow_phi:
                verdict = "slow"
                if (elapsed >= self.dead_elapsed_s
                        and phi >= self.dead_phi):
                    verdict = "dead"
        return verdict, phi


# geometric bounds ~1ms .. 64s — wide enough for a tiny test engine and
# a real prefill; +Inf overflow clamps at 64s via the shared estimator
_BUDGET_BOUNDS = tuple(0.001 * (2.0 ** i) for i in range(17)) + (
    float("inf"),)


class LatencyBudget:
    """Quantile-of-observed-service hedging budget on cumulative
    histogram buckets (read through quantile_from_cumulative — THE
    estimator)."""

    def __init__(self, q=0.95, multiplier=2.0, floor_s=0.05,
                 min_samples=4):
        self.q = float(q)
        self.multiplier = float(multiplier)
        self.floor_s = float(floor_s)
        self.min_samples = int(min_samples)
        self._counts = [0] * len(_BUDGET_BOUNDS)
        self.n = 0

    def observe(self, seconds):
        s = float(seconds)
        for i, le in enumerate(_BUDGET_BOUNDS):
            if s <= le:
                self._counts[i] += 1
                break
        self.n += 1

    def budget(self):
        """Seconds a placement may run before it is hedge-worthy, or
        None while uncalibrated (too few samples = no hedging, never a
        guessed budget)."""
        if self.n < self.min_samples:
            return None
        cum, c = [], 0
        for le, cnt in zip(_BUDGET_BOUNDS, self._counts):
            c += cnt
            cum.append((le, c))
        est = quantile_from_cumulative(cum, self.q)
        if est is None:
            return None
        return max(self.floor_s, est * self.multiplier)

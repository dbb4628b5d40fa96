"""Embedded time-series store: deterministic scrapes of the metrics
registry into bounded ring-buffer series, plus the closed registry of
recording rules evaluated into derived series every tick.

The design contract (round 17):

- **Deterministic tick.** ``MetricsSampler.sample(now=None)`` never
  reads a wall clock. ``now`` is whatever monotone clock the caller
  owns: the serving engine passes nothing (an internal tick counter),
  mesh replicas pass their step counter, the load generator passes
  schedule time. Tests hand-drive the clock and get bit-identical
  series.
- **Bounded.** Every series is a ring buffer of at most ``retention``
  points, and raw-series cardinality is capped at ``max_series`` —
  past the cap new series are dropped and counted, the tenant-overflow
  discipline applied to series keys. ``rule/*`` series are exempt:
  RECORDING_RULES is a closed registry, bounded by construction.
- **Counter→rate.** Counters are stored as per-window rates
  (delta / dt); histograms keep the previous cumulative buckets so the
  quantile rules are *windowed* (this window's observations only) and
  computed by THE shared estimator (quantiles.quantile_from_cumulative)
  — a recording rule and an operator's metrics_dump can never disagree
  about what "p95 TTFT" means.
- **Never raises.** Any failure inside ``sample()`` — including the
  chaos-drilled ``obs.sample`` fault site — flips the sampler to
  degraded (plane off), bumps ``obs_plane_degradations_total{what}``
  and returns False. Serving is never touched (drill-pinned
  byte-identical greedy streams).

Snapshot format (``snapshot_doc()`` / ``load_doc()``, format 1)::

    {"format": 1, "tick": <last now or None>, "retention": N,
     "series": [{"name": ..., "labels": {...}, "kind":
                 "gauge"|"rate"|"derived", "points": [[t, v], ...]}]}

The round-trip restores every point; the rate/window priming state is
deliberately NOT serialized — the first ``sample()`` after a load
re-primes counters, so one tick of rates is skipped, never wrong.

Port: a copy of `paddle_tpu/observability/timeseries.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import collections

from .catalog import metric as _metric
from .metrics import get_registry, snapshot
from .quantiles import quantile_from_cumulative

__all__ = ["RECORDING_RULES", "Series", "MetricsSampler", "load_doc",
           "DEFAULT_RETENTION", "MAX_SERIES"]

DEFAULT_RETENTION = 512
MAX_SERIES = 256

# The closed registry of recording rules: name -> meaning. Every rule
# is evaluated into a derived series named ``rule/<name>`` on each tick
# (from the second tick on — rules are windowed and need a previous
# scrape). static_check.py rule "recording-rules" pins this dict to the
# `rule/NAME` table in OBSERVABILITY.md, both directions, and
# tests/test_timeseries.py pins it to _RULE_EVALUATORS.
RECORDING_RULES = {
    "goodput_rate": "finished-good requests per second (finish_reason "
                    "eos/length) over the tick window",
    "shed_fraction": "fraction of this window's finishes that were "
                     "shed/rejected (0.0 when nothing finished)",
    "ttft_p95": "p95 time-to-first-token over the tick window "
                "(shared estimator; holds last value on empty windows)",
    "tpot_p99": "p99 per-token decode latency over the tick window "
                "(shared estimator; holds last value on empty windows)",
    "slo_burn_rate": "max error-budget burn rate across SLOs "
                     "(0.0 when no SLO has reported)",
    "headroom_min": "min per-replica headroom across ALIVE replicas "
                    "(falls back to slo_headroom; 1.0 when unknown)",
    "headroom_sum": "sum of per-replica headroom across ALIVE replicas "
                    "(falls back to slo_headroom; 0.0 when unknown)",
    "brownout_max": "max brownout-ladder level across replicas "
                    "(0.0 = every engine normal)",
}

_GOOD_REASONS = ("eos", "length")
_SHED_REASONS = ("shed", "rejected")


class Series:
    """One bounded ring-buffer series of (t, value) points."""

    __slots__ = ("name", "labels", "kind", "points")

    def __init__(self, name, labels=(), kind="gauge",
                 retention=DEFAULT_RETENTION):
        self.name = str(name)
        if isinstance(labels, dict):
            labels = labels.items()
        self.labels = tuple(sorted(labels))
        self.kind = str(kind)
        self.points = collections.deque(maxlen=max(1, int(retention)))

    def add(self, t, value):
        self.points.append((float(t), float(value)))

    def latest(self):
        return self.points[-1][1] if self.points else None

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Series({self.name!r}, {dict(self.labels)!r}, "
                f"kind={self.kind!r}, n={len(self.points)})")


class _Window:
    """One tick's view of the scrape: per-metric gauge values, counter
    deltas, and histogram cumulative-bucket deltas — the only inputs a
    recording rule may read (keeps rules windowed by construction)."""

    __slots__ = ("dt", "gauges", "counter_deltas", "hist_deltas")

    def __init__(self, dt):
        self.dt = dt
        self.gauges = {}          # name -> [(labels_dict, value), ...]
        self.counter_deltas = {}  # name -> [(labels_dict, delta), ...]
        self.hist_deltas = {}     # name -> [[(le, delta_cum), ...], ...]


def _bucket_delta(cur, prev):
    """Windowed cumulative buckets: per-le delta of two cumulative
    snapshots (still cumulative in le, so the shared estimator applies
    directly)."""
    return [(le, max(0.0, float(c) - float(p)))
            for (le, c), (_ple, p) in zip(cur, prev)]


class MetricsSampler:
    """Scrape a metrics-snapshot-format source on a deterministic tick
    into bounded ring-buffer series and evaluate RECORDING_RULES.

    ``scrape`` is any zero-arg callable returning a metrics snapshot
    doc (metrics.snapshot() format 1); the default scrapes the
    process-wide registry. ``alive_filter`` — a callable returning the
    set of alive replica names (or a static set, or None) — restricts
    the headroom rules to live members so a dead replica's frozen
    gauges cannot poison mesh aggregates.
    """

    def __init__(self, scrape=None, retention=DEFAULT_RETENTION,
                 max_series=MAX_SERIES, alive_filter=None):
        self._scrape = scrape
        self.retention = max(1, int(retention))
        self.max_series = max(1, int(max_series))
        self.alive_filter = alive_filter
        self.series = {}           # (name, labels_tuple) -> Series
        self.enabled = True
        self.degraded = False
        self.samples = 0
        self.dropped_series = 0
        self._raw_series = 0       # non-rule series count (cap domain)
        self._auto_tick = 0.0
        self._last_now = None
        self._prev_counters = {}   # key -> last total
        self._prev_hists = {}      # key -> last cumulative buckets
        self._rule_last = {}       # hold-last state for quantile rules

    # --- the tick ----------------------------------------------------

    def sample(self, now=None):
        """One deterministic scrape tick. Returns True when a tick
        landed; False when the sampler is disabled/degraded, the clock
        did not advance, or the tick failed (which also degrades the
        plane — never the caller)."""
        if not self.enabled:
            return False
        try:
            from ..resilience.faults import fault_point
            fault_point("obs.sample")
            if now is None:
                now = self._auto_tick
            now = float(now)
            if self._last_now is not None and now <= self._last_now:
                return False
            doc = (self._scrape() if self._scrape is not None
                   else snapshot(get_registry()))
            win = self._ingest(doc, now)
            if win.dt is not None and win.dt > 0:
                self._evaluate_rules(win, now)
            self._last_now = now
            self._auto_tick = now + 1.0
            self.samples += 1
            _metric("obs_samples_total").inc()
            return True
        except Exception as e:  # plane off, serving untouched
            self._degrade(e)
            return False

    def _degrade(self, exc):
        self.enabled = False
        self.degraded = True
        try:
            _metric("obs_plane_degradations_total",
                    what=type(exc).__name__).inc()
        except Exception:
            pass

    # --- ingestion ---------------------------------------------------

    def _ingest(self, doc, now):
        dt = None if self._last_now is None else now - self._last_now
        win = _Window(dt)
        for m in doc.get("metrics", ()):
            name, mtype = m["name"], m["type"]
            for s in m.get("samples", ()):
                labels = tuple(sorted((s.get("labels") or {}).items()))
                key = (name, labels)
                if mtype == "counter":
                    cur = float(s["value"])
                    prev = self._prev_counters.get(key)
                    self._prev_counters[key] = cur
                    if not dt:
                        continue
                    # a child born mid-window deltas from 0, not skipped
                    delta = max(0.0, cur - (prev or 0.0))
                    win.counter_deltas.setdefault(name, []).append(
                        (dict(labels), delta))
                    self._record(key, "rate", now, delta / dt)
                elif mtype == "histogram":
                    cum = [(b[0], float(b[1]))
                           for b in (s.get("buckets") or ())]
                    prev = self._prev_hists.get(key)
                    self._prev_hists[key] = cum
                    if not dt:
                        continue
                    if prev is None:   # child born mid-window
                        prev = [(le, 0.0) for le, _c in cum]
                    win.hist_deltas.setdefault(name, []).append(
                        _bucket_delta(cum, prev))
                else:  # gauge (anything point-in-time)
                    value = float(s.get("value", 0.0))
                    win.gauges.setdefault(name, []).append(
                        (dict(labels), value))
                    self._record(key, "gauge", now, value)
        return win

    def _record(self, key, kind, t, value):
        s = self.series.get(key)
        if s is None:
            if self._raw_series >= self.max_series:
                self.dropped_series += 1
                return
            s = self.series[key] = Series(key[0], key[1], kind,
                                          self.retention)
            self._raw_series += 1
        s.add(t, value)

    # --- recording rules ---------------------------------------------

    def _evaluate_rules(self, win, now):
        for name, fn in _RULE_EVALUATORS.items():
            key = ("rule/" + name, ())
            s = self.series.get(key)
            if s is None:
                s = self.series[key] = Series(key[0], (), "derived",
                                              self.retention)
            s.add(now, fn(win, self))

    def _alive(self):
        f = self.alive_filter
        if f is None:
            return None
        return set(f() if callable(f) else f)

    def _headroom_values(self, win):
        alive = self._alive()
        out = []
        for labels, v in win.gauges.get("mesh_replica_headroom", ()):
            rep = labels.get("replica")
            if alive is not None and rep is not None and rep not in alive:
                continue  # dead replica: series frozen, aggregate clean
            out.append(v)
        if not out:
            out = [v for _l, v in win.gauges.get("slo_headroom", ())]
        return out

    def _windowed_quantile(self, win, name, q, rule):
        per_series = win.hist_deltas.get(name)
        if per_series:
            merged, order = {}, []
            for buckets in per_series:
                for le, d in buckets:
                    if le not in merged:
                        merged[le] = 0.0
                        order.append(le)
                    merged[le] += d
            v = quantile_from_cumulative([(le, merged[le]) for le in order],
                                         q)
            if v is not None:
                self._rule_last[rule] = float(v)
                return float(v)
        return self._rule_last.get(rule, 0.0)

    # --- reads -------------------------------------------------------

    def latest(self, name, **labels):
        s = self.series.get((name, tuple(sorted(labels.items()))))
        return s.latest() if s is not None else None

    def rule_latest(self, rule):
        return self.latest("rule/" + rule)

    def summary(self):
        """Machine-readable plane state: per-rule latest value + point
        count, series/sample totals, degradation flags."""
        rules = {}
        for name in RECORDING_RULES:
            s = self.series.get(("rule/" + name, ()))
            rules[name] = {"latest": s.latest() if s is not None else None,
                           "points": len(s.points) if s is not None else 0}
        return {"format": 1, "rules": rules, "series": len(self.series),
                "samples": self.samples,
                "dropped_series": self.dropped_series,
                "enabled": self.enabled, "degraded": self.degraded}

    def snapshot_doc(self):
        """JSON-serializable TSDB snapshot (format 1; see module doc)."""
        series = []
        for (name, labels), s in sorted(self.series.items()):
            series.append({"name": name, "labels": dict(labels),
                           "kind": s.kind,
                           "points": [[t, v] for t, v in s.points]})
        return {"format": 1, "tick": self._last_now,
                "retention": self.retention, "series": series}


def load_doc(doc):
    """Rebuild a MetricsSampler from snapshot_doc() output — the
    round-trip tools/dashboard.py renders from. Rate/window priming
    state is not serialized: the next sample() re-primes counters."""
    if not isinstance(doc, dict) or doc.get("format") != 1:
        fmt = doc.get("format") if isinstance(doc, dict) else type(doc)
        raise ValueError(f"not a timeseries snapshot (format {fmt!r})")
    out = MetricsSampler(retention=doc.get("retention", DEFAULT_RETENTION))
    out._last_now = doc.get("tick")
    if out._last_now is not None:
        out._auto_tick = float(out._last_now) + 1.0
    for row in doc.get("series", ()):
        s = Series(row["name"], dict(row.get("labels") or {}),
                   row.get("kind", "gauge"), out.retention)
        for t, v in row.get("points", ()):
            s.add(t, v)
        out.series[(s.name, s.labels)] = s
        if not s.name.startswith("rule/"):
            out._raw_series += 1
    return out


# rule name -> evaluator(window, sampler) -> float. Total functions:
# every rule emits a point on every evaluated tick (defaults documented
# in RECORDING_RULES) so "plane on" always means populated rule series.
def _rule_goodput_rate(win, smp):
    good = sum(d for labels, d
               in win.counter_deltas.get("serving_finished_total", ())
               if labels.get("reason") in _GOOD_REASONS)
    return good / win.dt


def _rule_shed_fraction(win, smp):
    total = bad = 0.0
    for labels, d in win.counter_deltas.get("serving_finished_total", ()):
        total += d
        if labels.get("reason") in _SHED_REASONS:
            bad += d
    return bad / total if total > 0 else 0.0


def _rule_ttft_p95(win, smp):
    return smp._windowed_quantile(win, "serving_ttft_seconds", 0.95,
                                  "ttft_p95")


def _rule_tpot_p99(win, smp):
    return smp._windowed_quantile(win, "serving_tpot_seconds", 0.99,
                                  "tpot_p99")


def _rule_slo_burn_rate(win, smp):
    vals = [v for _l, v in win.gauges.get("slo_burn_rate", ())]
    return max(vals) if vals else 0.0


def _rule_headroom_min(win, smp):
    vals = smp._headroom_values(win)
    return min(vals) if vals else 1.0


def _rule_headroom_sum(win, smp):
    vals = smp._headroom_values(win)
    return sum(vals) if vals else 0.0


def _rule_brownout_max(win, smp):
    vals = [v for _l, v in win.gauges.get("serving_brownout_level", ())]
    return max(vals) if vals else 0.0


_RULE_EVALUATORS = {
    "goodput_rate": _rule_goodput_rate,
    "shed_fraction": _rule_shed_fraction,
    "ttft_p95": _rule_ttft_p95,
    "tpot_p99": _rule_tpot_p99,
    "slo_burn_rate": _rule_slo_burn_rate,
    "headroom_min": _rule_headroom_min,
    "headroom_sum": _rule_headroom_sum,
    "brownout_max": _rule_brownout_max,
}

assert set(_RULE_EVALUATORS) == set(RECORDING_RULES), \
    "RECORDING_RULES and _RULE_EVALUATORS must list the same rules"

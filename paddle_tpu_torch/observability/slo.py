"""Declarative SLOs evaluated from windowed metrics snapshots.

The sensor half of the ROADMAP's "SLO-driven scheduler": specs say what
good looks like (`TTFT p95 <= 2.5s`, `99% of requests finish well`),
the engine turns a stream of metrics snapshots into a machine-readable
verdict plus `slo_compliance` / `slo_burn_rate` catalog gauges. The
evaluation core is DETERMINISTIC — callers supply snapshot dicts and
timestamps, the engine only diffs and interpolates — so the future
scheduler PR (and today's tests) can replay exact scenarios.

Two spec kinds:

* ``quantile`` — estimate quantile ``q`` of a histogram metric over the
  window and require it <= ``objective`` (seconds). Burn rate is the
  observed/objective ratio (1.0 = exactly at target).
* ``error_budget`` — of a labeled counter's window delta, the fraction
  matching ``good`` label values must be >= ``objective``. Burn rate is
  bad_fraction / (1 - objective): >1 spends the error budget faster
  than allowed.

Quantiles come from observability/quantiles.py — the SAME estimator
tools/metrics_dump.py prints, so a verdict and an operator's dump can
never disagree.

STANDALONE like metrics.py: stdlib only; loadable by path (tools/
slo_report.py runs on machines without jax). The catalog gauges are
emitted through a guarded import that standalone loads skip.

Port: a copy of `paddle_tpu/observability/slo.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import json
from collections import deque

try:
    from .quantiles import quantile_from_cumulative
except ImportError:     # loaded standalone by path: sibling file, same deal
    import importlib.util as _ilu
    import os as _os
    _p = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                       "quantiles.py")
    _s = _ilu.spec_from_file_location("_paddle_tpu_quantiles", _p)
    _m = _ilu.module_from_spec(_s)
    _s.loader.exec_module(_m)
    quantile_from_cumulative = _m.quantile_from_cumulative

__all__ = ["SLOSpec", "SLOEngine", "DEFAULT_SLOS", "parse_specs",
           "VERDICT_FORMAT"]

VERDICT_FORMAT = 1


class SLOSpec:
    """One declarative objective. `good` (error_budget only) maps a
    label name to the tuple of values that count as good outcomes.
    `labels` (optional, any kind) restricts the spec to samples whose
    labels match every given name=value pair — the per-adapter /
    per-tenant verdict scoping (round 22)."""

    __slots__ = ("name", "kind", "metric", "q", "objective", "good",
                 "labels")

    def __init__(self, name, kind, metric, objective, q=None, good=None,
                 labels=None):
        if kind not in ("quantile", "error_budget"):
            raise ValueError(f"unknown SLO kind {kind!r} "
                             "(want quantile|error_budget)")
        if kind == "quantile" and q is None:
            raise ValueError(f"SLO {name!r}: quantile kind needs q")
        if kind == "error_budget":
            if not good:
                raise ValueError(f"SLO {name!r}: error_budget needs good=")
            if not 0.0 < float(objective) < 1.0:
                raise ValueError(f"SLO {name!r}: error_budget objective "
                                 "must be in (0, 1)")
        self.name = str(name)
        self.kind = kind
        self.metric = str(metric)
        self.q = None if q is None else float(q)
        self.objective = float(objective)
        self.good = ({str(k): tuple(str(x) for x in v)
                      for k, v in good.items()} if good else None)
        self.labels = ({str(k): str(v) for k, v in labels.items()}
                       if labels else None)

    def state_key(self):
        """What one windowed observation is keyed by: two specs over
        the same metric with different label filters must not share
        state."""
        if not self.labels:
            return self.metric
        return (self.metric, tuple(sorted(self.labels.items())))

    def matches(self, sample_labels):
        if not self.labels:
            return True
        sl = sample_labels or {}
        return all(sl.get(k) == v for k, v in self.labels.items())

    @classmethod
    def from_dict(cls, d):
        return cls(d["name"], d["kind"], d["metric"], d["objective"],
                   q=d.get("q"), good=d.get("good"),
                   labels=d.get("labels"))

    def to_dict(self):
        d = {"name": self.name, "kind": self.kind, "metric": self.metric,
             "objective": self.objective}
        if self.q is not None:
            d["q"] = self.q
        if self.good is not None:
            d["good"] = {k: list(v) for k, v in self.good.items()}
        if self.labels is not None:
            d["labels"] = dict(self.labels)
        return d

    def __repr__(self):
        tail = (f"p{int(self.q * 100)}<={self.objective}"
                if self.kind == "quantile"
                else f"good>={self.objective}")
        return f"SLOSpec({self.name}: {self.metric} {tail})"


def parse_specs(doc):
    """[SLOSpec] from a JSON document (list of dicts, or a dict with a
    'slos' list) — the tools/slo_report.py --spec file format."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    if isinstance(doc, dict):
        doc = doc.get("slos", [])
    return [SLOSpec.from_dict(d) for d in doc]


# serving defaults: TTFT p95 within 2.5s, steady decode p99 within
# 250ms/token, and 99% of finishes being genuine completions
# (eos/length — timeout/shed/rejected burn the error budget)
DEFAULT_SLOS = (
    SLOSpec("ttft_p95", "quantile", "serving_ttft_seconds",
            objective=2.5, q=0.95),
    SLOSpec("tpot_p99", "quantile", "serving_tpot_seconds",
            objective=0.25, q=0.99),
    SLOSpec("availability", "error_budget", "serving_finished_total",
            objective=0.99, good={"reason": ("eos", "length")}),
)


# -- snapshot plumbing -------------------------------------------------------

def _find_metric(snapshot_doc, name):
    for m in snapshot_doc.get("metrics", []):
        if m.get("name") == name:
            return m
    return None


def _hist_state(mdict, spec=None):
    """Merge a histogram family's samples -> {le_key: cum} (le_key is
    float or '+Inf'), summing across label children — optionally only
    the children matching the spec's label filter."""
    merged = {}
    for s in mdict.get("samples", []):
        if spec is not None and not spec.matches(s.get("labels")):
            continue
        for le, cum in s.get("buckets", []):
            key = "+Inf" if (isinstance(le, str) or le == float("inf")) \
                else float(le)
            merged[key] = merged.get(key, 0) + int(cum)
    return merged


def _counter_state(mdict, spec=None):
    """Labeled counter family -> {(sorted label items): value}."""
    out = {}
    for s in mdict.get("samples", []):
        if spec is not None and not spec.matches(s.get("labels")):
            continue
        key = tuple(sorted((s.get("labels") or {}).items()))
        out[key] = out.get(key, 0.0) + float(s.get("value", 0.0))
    return out


def _extract(snapshot_doc, specs):
    """One windowed observation: per spec metric (and label filter), the
    cumulative state needed to diff later."""
    state = {}
    for spec in specs:
        m = _find_metric(snapshot_doc, spec.metric)
        if m is None:
            continue
        state[spec.state_key()] = (
            _hist_state(m, spec) if spec.kind == "quantile"
            else _counter_state(m, spec))
    return state


def _diff_hist(new, old):
    """Cumulative-bucket delta as the [(le, cum), ...] the estimator
    eats ('+Inf' kept last)."""
    finite = sorted(k for k in new if k != "+Inf")
    out = [(le, max(0, new.get(le, 0) - (old or {}).get(le, 0)))
           for le in finite]
    out.append(("+Inf", max(0, new.get("+Inf", 0)
                            - (old or {}).get("+Inf", 0))))
    return out


def _diff_counter(new, old):
    return {k: max(0.0, v - (old or {}).get(k, 0.0)) for k, v in new.items()}


class SLOEngine:
    """Feed it snapshots over time; ask for a verdict.

        eng = SLOEngine()                      # DEFAULT_SLOS, 300s window
        eng.observe(metrics.snapshot(reg), t=now)
        verdict = eng.evaluate(t=now)          # also sets the gauges

    evaluate() diffs the newest observation against the one at (or just
    before) the window start, so the verdict reflects the last
    `window_s` seconds, not process lifetime. With a single observation
    the baseline is empty — everything ever recorded counts, which is
    exactly what a one-shot bench wants."""

    def __init__(self, specs=None, window_s=300.0):
        self.specs = list(specs if specs is not None else DEFAULT_SLOS)
        self.window_s = float(window_s)
        self._series = deque()      # (t, {metric: cumulative state})

    def observe(self, snapshot_doc, t):
        """Record one metrics snapshot taken at time `t` (caller's
        clock; only differences matter)."""
        t = float(t)
        self._series.append((t, _extract(snapshot_doc, self.specs)))
        cutoff = t - self.window_s
        # keep exactly one observation at/before the window start as the
        # diff baseline; drop anything older
        while len(self._series) >= 2 and self._series[1][0] <= cutoff:
            self._series.popleft()

    def _window(self):
        if not self._series:
            return None, None
        newest = self._series[-1][1]
        baseline = self._series[0][1] if len(self._series) >= 2 else {}
        return baseline, newest

    def evaluate(self, emit=True):
        """-> verdict dict (see VERDICT_FORMAT). Deterministic given the
        observed snapshots. When `emit`, also sets slo_compliance /
        slo_burn_rate on the process registry (skipped standalone)."""
        baseline, newest = self._window()
        results = []
        for spec in self.specs:
            r = {"name": spec.name, "kind": spec.kind,
                 "metric": spec.metric, "objective": spec.objective}
            if spec.q is not None:
                r["q"] = spec.q
            if spec.labels is not None:
                r["labels"] = dict(spec.labels)
            new = (newest or {}).get(spec.state_key())
            old = (baseline or {}).get(spec.state_key())
            if spec.kind == "quantile":
                if new is None:
                    r.update(ok=True, no_data=True, observed=None,
                             burn_rate=0.0, count=0)
                else:
                    buckets = _diff_hist(new, old)
                    count = buckets[-1][1] if buckets else 0
                    obs = quantile_from_cumulative(buckets, spec.q)
                    if obs is None:
                        r.update(ok=True, no_data=True, observed=None,
                                 burn_rate=0.0, count=0)
                    else:
                        r.update(ok=obs <= spec.objective, observed=obs,
                                 burn_rate=obs / spec.objective,
                                 count=count)
            else:   # error_budget
                if new is None:
                    r.update(ok=True, no_data=True, good=0, total=0,
                             burn_rate=0.0)
                else:
                    delta = _diff_counter(new, old)
                    total = sum(delta.values())
                    good = 0.0
                    for key, v in delta.items():
                        labels = dict(key)
                        if all(labels.get(ln) in vals
                               for ln, vals in spec.good.items()):
                            good += v
                    if total <= 0:
                        r.update(ok=True, no_data=True, good=0, total=0,
                                 burn_rate=0.0)
                    else:
                        bad_frac = (total - good) / total
                        budget = 1.0 - spec.objective
                        r.update(ok=(good / total) >= spec.objective,
                                 good=int(good), total=int(total),
                                 good_fraction=good / total,
                                 burn_rate=bad_frac / budget)
            results.append(r)
        verdict = {"format": VERDICT_FORMAT, "window_s": self.window_s,
                   "ok": all(r["ok"] for r in results), "slos": results}
        if emit:
            self._emit(results)
        return verdict

    @staticmethod
    def _emit(results):
        try:        # guarded: absent in standalone loads / metrics off
            from .catalog import metric
        except ImportError:
            return
        try:
            for r in results:
                metric("slo_compliance", slo=r["name"]).set(
                    1.0 if r["ok"] else 0.0)
                metric("slo_burn_rate", slo=r["name"]).set(
                    float(r.get("burn_rate") or 0.0))
        except Exception:   # noqa: BLE001 — verdicts never fail on gauges
            pass

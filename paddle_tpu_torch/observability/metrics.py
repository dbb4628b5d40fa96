"""Thread-safe process-wide metric registry.

reference capability: the reference scatters runtime evidence across
ad-hoc artifacts (profiler host-event tables, benchmark timers in
python/paddle/profiler/timer.py, per-tool JSON logs). This module is the
single substrate: Counter / Gauge / Histogram with labels, exported as
Prometheus text or a JSONL snapshot that bench rows can embed verbatim.

Deliberately STANDALONE: stdlib only, no package-relative imports — so
`bench.py`'s orchestrating parent (which must never import jax) and
`tools/metrics_dump.py` can load this file directly via
importlib.util.spec_from_file_location.

Zero-cost when disabled: every mutation starts with one attribute check
(`self._state.enabled`) and returns before taking the lock or touching
any state — the no-op path allocates nothing per call (guarded by
tests/test_observability.py::test_disabled_noop_allocates_nothing).

Port: a copy of `paddle_tpu/observability/metrics.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time

__all__ = ["MetricRegistry", "Counter", "Gauge", "Histogram",
           "get_registry", "to_prometheus_text", "snapshot",
           "load_snapshot", "write_snapshot_jsonl", "read_snapshot_jsonl",
           "SNAPSHOT_FORMAT", "DEFAULT_BUCKETS"]

SNAPSHOT_FORMAT = 1

# latency-oriented defaults (seconds), prometheus-client-compatible
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# distinct label sets per metric; beyond this a labels() call raises —
# unbounded cardinality is the classic way a metrics layer eats a server
MAX_LABEL_SETS = 256


class _State:
    """Shared mutable enable flag; children cache a reference so the
    disabled fast path is a single attribute load."""

    __slots__ = ("enabled",)

    def __init__(self, enabled=False):
        self.enabled = bool(enabled)


def _env_default() -> bool:
    return os.environ.get("FLAGS_observability", "").lower() in (
        "1", "true", "yes", "on")


class _Child:
    """One (metric, label-set) time series."""

    __slots__ = ("_state", "_lock", "labels_kv")

    def __init__(self, state, labels_kv):
        self._state = state
        self._lock = threading.Lock()
        self.labels_kv = labels_kv          # tuple of (k, v) pairs, sorted


class Counter(_Child):
    __slots__ = ("_value",)

    def __init__(self, state, labels_kv=()):
        super().__init__(state, labels_kv)
        self._value = 0.0

    def inc(self, v=1):
        if not self._state.enabled:
            return
        if v < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += v

    @property
    def value(self):
        return self._value


class Gauge(_Child):
    __slots__ = ("_value",)

    def __init__(self, state, labels_kv=()):
        super().__init__(state, labels_kv)
        self._value = 0.0

    def set(self, v):
        if not self._state.enabled:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, v=1):
        if not self._state.enabled:
            return
        with self._lock:
            self._value += v

    def dec(self, v=1):
        self.inc(-v)

    @property
    def value(self):
        return self._value


class Histogram(_Child):
    """Cumulative-bucket histogram, `le` (<=) semantics like Prometheus.

    `observe(v, exemplar=...)` attaches an OpenMetrics-style exemplar —
    a trace id pinned to the bucket the value landed in — so a bad p99
    bucket links to the exact request trace that produced it. Last
    exemplar per bucket wins (bounded memory: at most one per bucket)."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_exemplars")

    def __init__(self, state, labels_kv=(), buckets=DEFAULT_BUCKETS):
        super().__init__(state, labels_kv)
        self._bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._bounds) + 1)   # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._exemplars = None     # lazily {bucket_idx: (trace_id, value)}

    def observe(self, v, exemplar=None):
        if not self._state.enabled:
            return
        with self._lock:
            idx = bisect.bisect_left(self._bounds, v)
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[idx] = (str(exemplar), float(v))

    def exemplars(self):
        """[(le, trace_id, value), ...] — the last exemplar recorded per
        bucket ('+Inf' for the overflow bucket)."""
        with self._lock:
            if not self._exemplars:
                return []
            out = []
            for idx in sorted(self._exemplars):
                le = (self._bounds[idx] if idx < len(self._bounds)
                      else "+Inf")
                tid, val = self._exemplars[idx]
                out.append((le, tid, val))
            return out

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count

    def cumulative_buckets(self):
        """[(le, cumulative_count), ...] ending with ('+Inf', count)."""
        out, acc = [], 0
        for b, c in zip(self._bounds, self._counts):
            acc += c
            out.append((b, acc))
        out.append(("+Inf", self._count))
        return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Metric:
    """A named metric family: help text, declared label names, children."""

    def __init__(self, state, name, mtype, help_="", labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        self.name = name
        self.type = mtype
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._state = state
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if not self.labelnames:   # unlabeled: the family IS its one child
            self._children[()] = self._make(())

    def _make(self, labels_kv):
        cls = _TYPES[self.type]
        if self.type == "histogram":
            return cls(self._state, labels_kv, self.buckets)
        return cls(self._state, labels_kv)

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}, "
                f"got {tuple(kw)}")
        key = tuple(sorted((k, str(v)) for k, v in kw.items()))
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= MAX_LABEL_SETS:
                        raise ValueError(
                            f"{self.name}: label cardinality cap "
                            f"({MAX_LABEL_SETS}) exceeded — label values "
                            "must come from a small closed set")
                    child = self._make(key)
                    self._children[key] = child
        return child

    # unlabeled convenience: family forwards to its single child
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} requires .labels(...) — "
                             f"declared labels {self.labelnames}")
        return self._children[()]

    def inc(self, v=1):
        self._solo().inc(v)

    def set(self, v):
        self._solo().set(v)

    def dec(self, v=1):
        self._solo().dec(v)

    def observe(self, v, exemplar=None):
        self._solo().observe(v, exemplar)

    @property
    def value(self):
        return self._solo().value

    @property
    def sum(self):
        return self._solo().sum

    @property
    def count(self):
        return self._solo().count

    def cumulative_buckets(self):
        return self._solo().cumulative_buckets()

    def exemplars(self):
        return self._solo().exemplars()

    def children(self):
        with self._lock:
            return dict(self._children)


class MetricRegistry:
    """Process-wide metric table. get-or-create by name; re-registering
    with a conflicting type/labels/buckets raises (the no-drift contract
    tests/test_observability.py pins for the catalog)."""

    def __init__(self, enabled=None):
        self._state = _State(_env_default() if enabled is None else enabled)
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    # -- enable switch -------------------------------------------------------
    @property
    def enabled(self):
        return self._state.enabled

    def enable(self):
        self._state.enabled = True

    def disable(self):
        self._state.enabled = False

    # -- registration --------------------------------------------------------
    def _register(self, name, mtype, help_, labelnames, buckets):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.type != mtype or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.type} "
                        f"with labels {m.labelnames}; conflicting "
                        f"re-registration as {mtype} {tuple(labelnames)}")
                return m
            m = _Metric(self._state, name, mtype, help_, labelnames,
                        buckets)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", labels=()):
        return self._register(name, "counter", help_, labels,
                              DEFAULT_BUCKETS)

    def gauge(self, name, help_="", labels=()):
        return self._register(name, "gauge", help_, labels, DEFAULT_BUCKETS)

    def histogram(self, name, help_="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._register(name, "histogram", help_, labels, buckets)

    def get(self, name):
        return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def collect(self):
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self):
        """Zero every series, keep definitions (tests; between bench rows)."""
        for m in self.collect():
            with m._lock:
                for key in list(m._children):
                    m._children[key] = m._make(key)
                if not m.labelnames and () not in m._children:
                    m._children[()] = m._make(())


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------

def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _label_str(labels_kv, extra=()):
    parts = [f'{k}="{_esc(v)}"' for k, v in (*labels_kv, *extra)]
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v):
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus_text(registry: MetricRegistry) -> str:
    """Prometheus exposition text (the /metrics page body)."""
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_esc(m.help)}")
        lines.append(f"# TYPE {m.name} {m.type}")
        for key in sorted(m.children()):
            c = m.children()[key]
            if m.type == "histogram":
                # OpenMetrics exemplar suffixes ride the bucket lines the
                # exemplar landed in; plain-Prometheus scrapers treat the
                # '#' tail as a comment
                ex = {le: (tid, val) for le, tid, val in c.exemplars()}
                for le, n in c.cumulative_buckets():
                    ls = _label_str(key, (("le", _fmt(le) if le != "+Inf"
                                           else "+Inf"),))
                    suffix = ""
                    if le in ex:
                        tid, val = ex[le]
                        suffix = (f' # {{trace_id="{_esc(tid)}"}} '
                                  f"{_fmt(val)}")
                    lines.append(f"{m.name}_bucket{ls} {n}{suffix}")
                lines.append(f"{m.name}_sum{_label_str(key)} {_fmt(c.sum)}")
                lines.append(
                    f"{m.name}_count{_label_str(key)} {c.count}")
            else:
                lines.append(f"{m.name}{_label_str(key)} {_fmt(c.value)}")
    return "\n".join(lines) + "\n"


def snapshot(registry: MetricRegistry, meta=None) -> dict:
    """JSON-serializable snapshot of every series (bench rows embed this)."""
    metrics = []
    for m in registry.collect():
        samples = []
        for key in sorted(m.children()):
            c = m.children()[key]
            if m.type == "histogram":
                s = {"labels": dict(key), "sum": c.sum,
                     "count": c.count,
                     "buckets": [[le, n] for le, n in
                                 c.cumulative_buckets()]}
                ex = c.exemplars()
                if ex:
                    s["exemplars"] = [[le, tid, val] for le, tid, val in ex]
                samples.append(s)
            else:
                samples.append({"labels": dict(key), "value": c.value})
        metrics.append({"name": m.name, "type": m.type, "help": m.help,
                        "labelnames": list(m.labelnames),
                        "buckets": (list(m.buckets)
                                    if m.type == "histogram" else None),
                        "samples": samples})
    doc = {"format": SNAPSHOT_FORMAT, "recorded_unix": int(time.time()),
           "metrics": metrics}
    if meta:
        doc["meta"] = dict(meta)
    return doc


def load_snapshot(doc) -> MetricRegistry:
    """Rebuild a registry from snapshot() output (dict or JSON string) —
    the round-trip bench rows and tools/metrics_dump.py rely on."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    if not isinstance(doc, dict) or doc.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"not a metrics snapshot (format "
                         f"{SNAPSHOT_FORMAT} expected): {type(doc)}")
    reg = MetricRegistry(enabled=True)
    for m in doc.get("metrics", []):
        name, mtype = m["name"], m["type"]
        labelnames = tuple(m.get("labelnames") or ())
        if mtype == "histogram":
            fam = reg.histogram(name, m.get("help", ""), labelnames,
                                tuple(m.get("buckets") or DEFAULT_BUCKETS))
        elif mtype == "gauge":
            fam = reg.gauge(name, m.get("help", ""), labelnames)
        else:
            fam = reg.counter(name, m.get("help", ""), labelnames)
        for s in m.get("samples", []):
            child = fam.labels(**s["labels"]) if labelnames else fam._solo()
            if mtype == "histogram":
                cum = {(le if le == "+Inf" else float(le)): n
                       for le, n in s.get("buckets", [])}
                prev = 0
                for i, b in enumerate(child._bounds):
                    cur = cum.get(b, prev)
                    child._counts[i] = cur - prev
                    prev = cur
                child._count = int(s.get("count", prev))
                child._counts[-1] = child._count - prev
                child._sum = float(s.get("sum", 0.0))
                for le, tid, val in s.get("exemplars", []):
                    idx = (len(child._bounds) if le == "+Inf"
                           else child._bounds.index(float(le)))
                    if child._exemplars is None:
                        child._exemplars = {}
                    child._exemplars[idx] = (str(tid), float(val))
            else:
                child._value = float(s.get("value", 0.0))
    return reg


def write_snapshot_jsonl(path, registry: MetricRegistry, meta=None):
    """One header line + one line per metric family (append-friendly,
    same spirit as the bench ledger .bench_tpu_wins.jsonl)."""
    doc = snapshot(registry, meta)
    with open(path, "w") as f:
        f.write(json.dumps({"format": doc["format"],
                            "recorded_unix": doc["recorded_unix"],
                            **({"meta": doc["meta"]} if "meta" in doc
                               else {})}) + "\n")
        for m in doc["metrics"]:
            f.write(json.dumps(m) + "\n")
    return path


def read_snapshot_jsonl(path) -> dict:
    """Inverse of write_snapshot_jsonl: -> snapshot() dict."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or "format" not in lines[0]:
        raise ValueError(f"{path}: not a JSONL metrics snapshot")
    doc = dict(lines[0])
    doc["metrics"] = lines[1:]
    return doc


# --------------------------------------------------------------------------
# default (process-wide) registry
# --------------------------------------------------------------------------

_default_registry: MetricRegistry | None = None
_default_lock = threading.Lock()


def get_registry() -> MetricRegistry:
    global _default_registry
    if _default_registry is None:
        with _default_lock:
            if _default_registry is None:
                _default_registry = MetricRegistry()
    return _default_registry

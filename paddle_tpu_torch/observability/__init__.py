"""Unified runtime observability: metrics registry, span tracing, SLO
telemetry — one substrate for train / serve / bench evidence.

reference capability: the reference's runtime evidence is split across
the profiler host-event table (python/paddle/profiler/), timer.py
throughput benchmarks, and per-tool logs. Here a single always-on layer
feeds every consumer: `MetricRegistry` (Counter/Gauge/Histogram with
labels; Prometheus text + JSONL snapshot exporters), a span `Tracer`
(monotonic clocks, parent/child nesting, Chrome-trace export that also
backs profiler.export_chrome_tracing), and `StepWatch` training
telemetry (step time, online tokens/s + MFU, bench-ledger-schema JSONL).

Disabled by default — `FLAGS_observability` (env or paddle.set_flags)
or `observability.enable()` turns it on. Every mutation has a no-op
fast path (one attribute check, zero allocation) so tier-1 timing and
TPU step time are unaffected when off.

Instrumented hot paths: inference/serving.py (TTFT, TPOT, queue depth,
occupancy, pool gauge, admission counters), generation.generate,
ops/pallas/attention_router (decision-source counters), bench.py (rows
embed registry snapshots), distributed elastic recovery (restart/resume
counters). The canonical metric-name catalog lives in catalog.py and is
documented in OBSERVABILITY.md (drift is test-pinned).

Port: a copy of `paddle_tpu/observability/__init__.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

from . import (  # noqa: F401
    autoscale, catalog, export, federation, metrics, quantiles, recorder,
    slo, timeseries, tracing)
from .autoscale import AutoscaleAdvisor  # noqa: F401
from .catalog import CATALOG, metric, register_all  # noqa: F401
from .federation import MeshCollector  # noqa: F401
from .export import prometheus_text, snapshot  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, get_registry,
    load_snapshot, to_prometheus_text)
from .quantiles import (  # noqa: F401
    quantile_from_cumulative, quantiles_from_cumulative)
from .recorder import FlightRecorder, get_recorder  # noqa: F401
from .slo import DEFAULT_SLOS, SLOEngine, SLOSpec  # noqa: F401
from .stepwatch import StepWatch, current_round  # noqa: F401
from .timeseries import (  # noqa: F401
    RECORDING_RULES, MetricsSampler, Series)
from .tracing import (  # noqa: F401
    Tracer, get_tracer, new_trace_id, span, trace)

__all__ = ["enable", "disable", "enabled", "MetricRegistry", "Counter",
           "Gauge", "Histogram", "get_registry", "snapshot",
           "to_prometheus_text", "load_snapshot", "Tracer", "get_tracer",
           "span", "trace", "new_trace_id", "StepWatch", "current_round",
           "CATALOG", "metric", "register_all", "FlightRecorder",
           "get_recorder", "SLOEngine", "SLOSpec", "DEFAULT_SLOS",
           "quantile_from_cumulative", "quantiles_from_cumulative",
           "MetricsSampler", "Series", "RECORDING_RULES", "MeshCollector",
           "AutoscaleAdvisor", "autoscale", "catalog", "export",
           "federation", "metrics", "quantiles", "recorder", "slo",
           "timeseries", "tracing"]


def _count_dropped(n):
    # tracing.py is standalone and cannot name the catalog itself; the
    # package wires the ring-wrap casualties into the metric here
    try:
        metric("tracer_dropped_spans_total").inc(n)
    except Exception:  # noqa: BLE001 — tracing never raises
        pass


def enable():
    """Turn the whole layer on (metrics + spans + recorder)."""
    get_registry().enable()
    tr = get_tracer()
    tr.enable()
    if tr.on_drop is None:
        tr.on_drop = _count_dropped
    get_recorder().enable()


def disable():
    get_registry().disable()
    get_tracer().disable()
    get_recorder().disable()


def enabled() -> bool:
    return get_registry().enabled


def _sync_with_flag():
    """Honor FLAGS_observability at import and via paddle.set_flags (the
    flags registry calls back into this module on set)."""
    try:
        from ..framework import flags as _flags
        v = _flags.flag_value("observability")
    except Exception:
        return
    s = str(v).lower()
    if s in ("1", "true", "yes", "on"):
        enable()
    elif s in ("0", "false", "no", "off"):
        disable()


_sync_with_flag()

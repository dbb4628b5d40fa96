"""Exporter runbook helpers: one call dumps everything a process knows.

The heavy lifting lives in metrics.py (Prometheus text / JSONL snapshot)
and tracing.py (Chrome trace); this module is the convenience layer the
OBSERVABILITY.md runbook documents.

Port: a copy of `paddle_tpu/observability/export.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import os

from . import metrics as _metrics
from . import recorder as _recorder
from . import tracing as _tracing

__all__ = ["prometheus_text", "snapshot", "write_snapshot_jsonl",
           "write_prometheus_text", "export_chrome_trace",
           "dump_flight_recorder", "dump_all"]


def prometheus_text(registry=None) -> str:
    return _metrics.to_prometheus_text(registry or _metrics.get_registry())


def snapshot(registry=None, meta=None) -> dict:
    return _metrics.snapshot(registry or _metrics.get_registry(), meta)


def write_snapshot_jsonl(path, registry=None, meta=None):
    return _metrics.write_snapshot_jsonl(
        path, registry or _metrics.get_registry(), meta)


def write_prometheus_text(path, registry=None):
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path


def export_chrome_trace(path, tracer=None, marker=0):
    return (tracer or _tracing.get_tracer()).export_chrome_trace(
        path, marker)


def dump_flight_recorder(path, rec=None, reason="manual", extra=None):
    return (rec or _recorder.get_recorder()).dump(path, reason=reason,
                                                  extra=extra)


def dump_all(dir_name, prefix="obs", registry=None, tracer=None, meta=None,
             rec=None):
    """Write <dir>/<prefix>.metrics.jsonl, .prom, .trace.json,
    .flight.json; returns the four paths. The one-call exporter for
    shutdown hooks and debugging."""
    os.makedirs(dir_name, exist_ok=True)
    p1 = write_snapshot_jsonl(
        os.path.join(dir_name, f"{prefix}.metrics.jsonl"), registry, meta)
    p2 = write_prometheus_text(
        os.path.join(dir_name, f"{prefix}.prom"), registry)
    p3 = export_chrome_trace(
        os.path.join(dir_name, f"{prefix}.trace.json"), tracer)
    p4 = dump_flight_recorder(
        os.path.join(dir_name, f"{prefix}.flight.json"), rec)
    return p1, p2, p3, p4

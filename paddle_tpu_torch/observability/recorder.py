"""Flight recorder: a bounded ring of typed engine events, dumped on crash.

The "black box" for the serving runbook. The engine appends tiny typed
events (dispatch/readback with lane epochs, membership changes, fault
fires, shed/timeout/backpressure, compile-cache hits/misses) into a
PREALLOCATED ring — recording is a slot assignment under a lock, no
growth — and on an unhandled exception, a SIGTERM preemption, or a
chaos-drill escape path the last N events are dumped to a postmortem
JSON an operator (or tools/chaos_drill.py) can read.

STANDALONE like metrics.py/tracing.py: stdlib only, loadable via
importlib.util.spec_from_file_location outside the package. The
`flight_recorder_dumps_total` catalog counter is wired through a
guarded import so standalone loads simply skip it.

Disabled-mode contract (same as the metrics registry): every mutation
starts with one attribute check and returns before touching the ring,
so a disabled recorder allocates nothing on the hot path — callers that
would build kwargs dicts must guard with `if rec.enabled:` themselves
(argument packing happens at the call site, before we can bail).

Port: a copy of `paddle_tpu/observability/recorder.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

__all__ = ["FlightRecorder", "EVENT_KINDS", "get_recorder",
           "default_dump_path", "validate_dump", "install_crash_handlers",
           "DUMP_FORMAT", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 4096
DUMP_FORMAT = 1

# The closed set of event kinds (catalog discipline, like FAULT_SITES):
# recording an unknown kind raises, so the dump schema in
# OBSERVABILITY.md and validate_dump() below can enumerate them.
EVENT_KINDS = {
    "dispatch": "decode tile launched (tile id, lanes, epochs, k)",
    "readback": "decode tile device->host readback drained",
    "membership": "decode lane set changed (lane retired/admitted, "
                  "device state re-uploaded)",
    "admit": "request admitted to a lane",
    "finish": "request finished (reason: eos|length|error|timeout|shed)",
    "shed": "request shed under pressure (requeued or rejected)",
    "timeout": "request deadline expired",
    "backpressure": "admission rejected: queue at capacity",
    "fault": "fault-injection site fired (site, hit number)",
    "preempt": "SIGTERM preemption acknowledged by the supervisor",
    "compile_cache": "PIR compile-cache probe (hit|miss|corrupt|store)",
    "pir_pipeline": "PIR pass pipeline ran (pass count, cache status)",
    "retry": "resilient retry of a transient failure",
    "degrade": "serving runtime permanently dropped a feature "
               "(speculation_off | kv_bf16 | sched_fifo) after a fault, "
               "or degraded one prefix-cache op to a miss (prefix_miss)",
    "prefix_hit": "admission resolved leading paged-KV blocks from the "
                  "cross-request prefix cache (rid, tokens, blocks)",
    "sched": "SLO scheduler action (brownout level transition, lane "
             "preempt/resume, best_effort shed)",
    "error": "unhandled error captured by a crash handler",
    "note": "free-form marker (drills, tests)",
    "profile": "profiler/loadgen summary (phase coverage, scenario, "
               "goodput) recorded at the end of a harness run",
    "mesh": "serving-mesh action (route pick, paged-KV handoff, "
            "replica failover/tombstone) with the request trace id so "
            "cross-replica timelines join",
    "controller": "mesh autoscale controller action (scale_up spawn, "
                  "drain_begin, scale_down retire, drain_forced kill, "
                  "latch_off back to advisory-only)",
    "adapter": "adapter store lifecycle (hot-load into a pool slot, "
               "LRU evict of an idle slot, typed admission reject on a "
               "store fault) with the adapter name and slot id",
}


def default_dump_path():
    """Where postmortems land: $FLAGS_flight_recorder_dir (or the
    tempdir) / flight-<pid>-<monotonic-ish>.json."""
    root = os.environ.get("FLAGS_flight_recorder_dir") or tempfile.gettempdir()
    return os.path.join(
        root, f"flight-{os.getpid()}-{time.time_ns() // 1_000_000}.json")


class FlightRecorder:
    """Bounded ring of typed events. `capacity` slots are preallocated;
    record() overwrites the oldest once full (seq keeps total order)."""

    __slots__ = ("enabled", "capacity", "_buf", "_seq", "_lock",
                 "_dumps", "_t0_ns")

    def __init__(self, enabled=False, capacity=DEFAULT_CAPACITY):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        if self.capacity <= 0:
            raise ValueError("capacity must be positive")
        self._buf = [None] * self.capacity     # preallocated ring
        self._seq = 0                          # total events ever recorded
        self._lock = threading.Lock()
        self._dumps = 0
        self._t0_ns = time.monotonic_ns()

    # -- recording -----------------------------------------------------------
    def record(self, kind, **fields):
        """Append one event; slot assignment only, never grows. The
        disabled fast path is the first line — but note **fields packs a
        dict at the call site, so hot loops guard externally with
        `if rec.enabled:` before building arguments."""
        if not self.enabled:
            return
        if kind not in EVENT_KINDS:
            raise KeyError(f"unknown flight-recorder event kind {kind!r}; "
                           f"registered kinds: {sorted(EVENT_KINDS)}")
        t_ms = (time.monotonic_ns() - self._t0_ns) // 1_000_000
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._buf[seq % self.capacity] = (seq, t_ms, kind,
                                              fields or None)

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._buf = [None] * self.capacity
            self._seq = 0
            self._t0_ns = time.monotonic_ns()

    # -- inspection ----------------------------------------------------------
    def __len__(self):
        with self._lock:
            return min(self._seq, self.capacity)

    @property
    def total_recorded(self):
        return self._seq

    @property
    def dumps(self):
        return self._dumps

    def events(self):
        """Events oldest->newest as dicts (the dump's `events` shape)."""
        with self._lock:
            seq = self._seq
            start = max(0, seq - self.capacity)
            raw = [self._buf[i % self.capacity] for i in range(start, seq)]
        out = []
        for ev in raw:
            if ev is None:      # racing writer mid-wrap; skip the hole
                continue
            s, t_ms, kind, fields = ev
            d = {"seq": s, "t_ms": t_ms, "kind": kind}
            if fields:
                d.update(fields)
            out.append(d)
        return out

    def counts_by_kind(self):
        out = {}
        for ev in self.events():
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    # -- postmortem ----------------------------------------------------------
    def dump(self, path=None, reason="manual", extra=None):
        """Write the postmortem JSON; returns the path. Dumping works
        even when recording is disabled (the dump then documents an
        empty ring — still evidence the crash handler ran)."""
        path = path or default_dump_path()
        events = self.events()
        doc = {
            "format": DUMP_FORMAT,
            "reason": str(reason),
            "pid": os.getpid(),
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "capacity": self.capacity,
            "total_recorded": self._seq,
            "dropped": max(0, self._seq - self.capacity),
            "events": events,
        }
        if extra:
            doc["extra"] = dict(extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)
        self._dumps += 1
        try:        # guarded: absent in standalone loads
            from .catalog import metric
            metric("flight_recorder_dumps_total", reason=str(reason)).inc()
        except Exception:   # noqa: BLE001 — a postmortem never fails on metrics
            pass
        return path


_REQUIRED_EVENT_KEYS = ("seq", "t_ms", "kind")


def validate_dump(path):
    """Schema-check a postmortem file; returns the parsed dict or raises
    ValueError describing the corruption. tools/chaos_drill.py gates its
    exit code on this."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: dump is not a JSON object")
    if doc.get("format") != DUMP_FORMAT:
        raise ValueError(f"{path}: unknown dump format {doc.get('format')!r}")
    for key in ("reason", "pid", "capacity", "total_recorded", "events"):
        if key not in doc:
            raise ValueError(f"{path}: missing required key {key!r}")
    if not isinstance(doc["events"], list):
        raise ValueError(f"{path}: 'events' is not a list")
    prev_seq = -1
    for i, ev in enumerate(doc["events"]):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: events[{i}] is not an object")
        for key in _REQUIRED_EVENT_KEYS:
            if key not in ev:
                raise ValueError(f"{path}: events[{i}] missing {key!r}")
        if ev["kind"] not in EVENT_KINDS:
            raise ValueError(
                f"{path}: events[{i}] has unknown kind {ev['kind']!r}")
        if not isinstance(ev["seq"], int) or ev["seq"] <= prev_seq:
            raise ValueError(
                f"{path}: events[{i}] seq {ev['seq']!r} not increasing")
        prev_seq = ev["seq"]
    return doc


# --------------------------------------------------------------------------
# default (process-wide) recorder + crash handlers
# --------------------------------------------------------------------------

_default_recorder: FlightRecorder | None = None
_default_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _default_recorder
    if _default_recorder is None:
        with _default_lock:
            if _default_recorder is None:
                _default_recorder = FlightRecorder(
                    enabled=os.environ.get("FLAGS_observability", "")
                    .lower() in ("1", "true", "yes", "on"))
    return _default_recorder


_hooks_installed = False


def install_crash_handlers():
    """Chain sys.excepthook so an unhandled exception dumps the black
    box before the traceback prints. Idempotent. (SIGTERM preemption
    dumps are wired by the resilience supervisor, which owns that
    signal; doing both here would fight over the handler.)"""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        rec = get_recorder()
        try:
            rec.record("error", exc_type=exc_type.__name__, msg=str(exc)[:200])
            rec.dump(reason="unhandled_error")
        except Exception:   # noqa: BLE001 — never mask the real traceback
            pass
        prev(exc_type, exc, tb)

    sys.excepthook = hook

"""Span tracer: nested host-side timing with Chrome-trace JSON export.

reference capability: python/paddle/profiler/utils.py RecordEvent +
event_tracing.h host ranges — generalized into a parent/child span tree
on monotonic clocks that the profiler's `_ChromeTracingHandler` exports
(chrome://tracing / Perfetto load the emitted file directly).

STANDALONE like metrics.py: stdlib only, loadable outside the package.

Two entry points:
  - `span(name, **args)` — the gated context manager the hot paths use;
    when tracing is disabled it returns a shared no-op (no allocation).
  - `Tracer.begin/end` — ungated; profiler.RecordEvent uses these so its
    spans are ALWAYS recorded (pre-existing profiler contract).

Port: a copy of `paddle_tpu/observability/tracing.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Span", "Tracer", "get_tracer", "span", "trace",
           "enable", "disable", "enabled", "new_trace_id",
           "LANE_TID_BASE"]

# bound the in-memory buffer: long-running serving processes must not
# grow without limit. The ring IS the bound — when it wraps, the oldest
# spans are dropped and counted (Tracer.dropped_spans; the package wires
# tracer_dropped_spans_total onto on_drop) so a leak-free engine that
# under-exports is visible, not silent. Raise via Tracer(maxlen=...).
DEFAULT_MAXLEN = 20000

# request-scoped spans exported per serving lane get synthetic Chrome
# tids in this range so the trace viewer groups them by lane, not by the
# host thread that happened to book-keep them
LANE_TID_BASE = 1 << 20

_NEXT_TRACE = [0]
_TRACE_LOCK = threading.Lock()


def new_trace_id(prefix="t"):
    """Process-unique trace id: <prefix><pid-hex>-<counter-hex>. Cheap
    (no entropy syscall) and stable enough to join spans, exemplars, and
    flight-recorder events for one request."""
    with _TRACE_LOCK:
        _NEXT_TRACE[0] += 1
        n = _NEXT_TRACE[0]
    return f"{prefix}{os.getpid():x}-{n:06x}"


class Span:
    __slots__ = ("name", "t0_ns", "dur_ns", "tid", "seq", "parent", "args",
                 "trace_id", "links")

    def __init__(self, name, t0_ns, tid, seq, parent=None, args=None,
                 trace_id=None, links=None):
        self.name = name
        self.t0_ns = t0_ns
        self.dur_ns = None          # set by end()
        self.tid = tid
        self.seq = seq
        self.parent = parent        # parent span NAME ('' at top level)
        self.args = args
        self.trace_id = trace_id    # request-scoped correlation id
        self.links = links          # trace/span ids this span links to


class _Noop:
    """Shared zero-allocation context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Tracer:
    def __init__(self, enabled=False, maxlen=DEFAULT_MAXLEN):
        self._state_enabled = enabled
        self._maxlen = maxlen
        self._lock = threading.Lock()
        self._finished: list[Span] = []
        self._seq = 0
        self._local = threading.local()   # per-thread open-span stack
        self.dropped_spans = 0            # ring-wrap casualties (total)
        self.on_drop = None               # callable(n) — package wires the
                                          # tracer_dropped_spans_total counter
        self._tid_names: dict[int, str] = {}   # synthetic tid -> group label

    # -- enable switch -------------------------------------------------------
    @property
    def enabled(self):
        return self._state_enabled

    def enable(self):
        self._state_enabled = True

    def disable(self):
        self._state_enabled = False

    # -- recording (ungated core) -------------------------------------------
    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def begin(self, name, args=None, trace_id=None) -> Span:
        """Open a span unconditionally (profiler path). Pair with end()."""
        stack = self._stack()
        with self._lock:
            seq = self._seq
            self._seq += 1
        sp = Span(name, time.perf_counter_ns(), threading.get_ident(), seq,
                  parent=stack[-1].name if stack else "", args=args,
                  trace_id=trace_id)
        if trace_id is None and stack and stack[-1].trace_id is not None:
            sp.trace_id = stack[-1].trace_id    # inherit down the tree
        stack.append(sp)
        return sp

    def end(self, sp: Span):
        sp.dur_ns = time.perf_counter_ns() - sp.t0_ns
        stack = self._stack()
        # tolerate mispaired ends (a crashed child left on the stack)
        while stack and stack[-1] is not sp:
            stack.pop()
        if stack:
            stack.pop()
        with self._lock:
            self._finished.append(sp)
            self._trim_locked()

    def _trim_locked(self):
        over = len(self._finished) - self._maxlen
        if over > 0:
            del self._finished[:over]
            self.dropped_spans += over
            cb = self.on_drop
            if cb is not None:
                try:
                    cb(over)
                except Exception:   # noqa: BLE001 — tracing never raises
                    pass

    def add_span(self, name, t0_ns, dur_ns, trace_id=None, args=None,
                 tid=None, tid_name=None, links=None, parent=""):
        """Record an already-measured span retroactively — no interaction
        with the thread-local nesting stack. This is how the serving
        engine books request phases (queued, prefill chunks, decode-tile
        shares) whose lifetime spans many engine-thread stack frames."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            sp = Span(name, int(t0_ns),
                      threading.get_ident() if tid is None else int(tid),
                      seq, parent=parent, args=args, trace_id=trace_id,
                      links=list(links) if links else None)
            sp.dur_ns = max(int(dur_ns), 0)
            if tid is not None and tid_name is not None:
                self._tid_names.setdefault(int(tid), str(tid_name))
            self._finished.append(sp)
            self._trim_locked()
        return sp

    # -- gated context manager / decorator ----------------------------------
    def span(self, name, **args):
        if not self._state_enabled:
            return _NOOP
        trace_id = args.pop("trace_id", None)
        return _SpanCtx(self, name, args or None, trace_id)

    def trace(self, name=None):
        """Decorator form: @tracer.trace("my.phase")."""
        def wrap(fn):
            label = name or fn.__qualname__

            def inner(*a, **kw):
                if not self._state_enabled:
                    return fn(*a, **kw)
                sp = self.begin(label)
                try:
                    return fn(*a, **kw)
                finally:
                    self.end(sp)
            inner.__name__ = fn.__name__
            inner.__qualname__ = fn.__qualname__
            inner.__doc__ = fn.__doc__
            return inner
        return wrap

    # -- inspection / export -------------------------------------------------
    def marker(self) -> int:
        """Sequence watermark; pass to spans_since()/export for 'only what
        happened after this point' (profiler start() snapshots one)."""
        with self._lock:
            return self._seq

    def spans_since(self, marker=0):
        with self._lock:
            return [s for s in self._finished if s.seq >= marker]

    def clear(self):
        with self._lock:
            self._finished.clear()

    def durations_by_name(self, marker=0):
        """{name: [seconds, ...]} — backs profiler.Profiler.summary()."""
        out: dict[str, list] = {}
        for s in self.spans_since(marker):
            if s.dur_ns is not None:
                out.setdefault(s.name, []).append(s.dur_ns / 1e9)
        return out

    def chrome_trace_events(self, marker=0):
        """Chrome-trace 'X' (complete) events; nesting renders from
        timestamp containment per tid, parent also kept in args."""
        pid = os.getpid()
        events = []
        seen_tids = set()
        for s in self.spans_since(marker):
            if s.dur_ns is None:
                continue
            args = dict(s.args) if s.args else {}
            if s.parent:
                args["parent"] = s.parent
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
            if s.links:
                args["links"] = list(s.links)
            seen_tids.add(s.tid)
            events.append({"name": s.name, "ph": "X", "pid": pid,
                           "tid": s.tid, "ts": s.t0_ns / 1e3,
                           "dur": s.dur_ns / 1e3, "args": args})
        # name synthetic lane tids so the viewer groups request spans by
        # lane; only emitted when such spans exist (plain engine traces
        # keep their exact event set)
        with self._lock:
            named = [(t, n) for t, n in sorted(self._tid_names.items())
                     if t in seen_tids]
        for tid, label in named:
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": label}})
        return events

    def export_chrome_trace(self, path, marker=0):
        doc = {"traceEvents": self.chrome_trace_events(marker),
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_args", "_span", "_trace_id")

    def __init__(self, tracer, name, args, trace_id=None):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._trace_id = trace_id

    def __enter__(self):
        self._span = self._tracer.begin(self._name, self._args,
                                        trace_id=self._trace_id)
        return self._span

    def __exit__(self, *exc):
        self._tracer.end(self._span)
        return False


# --------------------------------------------------------------------------
# default (process-wide) tracer
# --------------------------------------------------------------------------

_default_tracer: Tracer | None = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer(
                    enabled=os.environ.get("FLAGS_observability", "")
                    .lower() in ("1", "true", "yes", "on"))
    return _default_tracer


def span(name, **args):
    """Module-level `with span("serving.step"):` over the default tracer."""
    return get_tracer().span(name, **args)


def trace(name=None):
    return get_tracer().trace(name)


def enable():
    get_tracer().enable()


def disable():
    get_tracer().disable()


def enabled() -> bool:
    return get_tracer().enabled

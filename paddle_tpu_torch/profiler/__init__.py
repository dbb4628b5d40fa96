"""Profiler. reference: paddle_tpu/profiler/__init__.py (itself after
python/paddle/profiler/: profiler.py:358 Profiler, ProfilerState:89,
RecordEvent in utils.py, statistics in profiler_statistic.py, timer.py).

Device tracing is `torch.profiler` (CUPTI on the card), where the reference
uses `jax.profiler`: a `Profiler` records CPU and CUDA activity, or only
the CPU when its targets name only `ProfilerTarget.CPU`; asking for the
card where there is none raises. `RecordEvent` ranges go through
`torch.profiler.record_function`, so they appear in the device trace, and
into the observability tracer's host spans, which `summary()` aggregates
and `export_chrome_tracing` writes beside the device trace.
`timer_only=True` traces nothing and only times steps. The per-phase
wall-time accountant that the serving engine marks is `phases.py`.
"""

from __future__ import annotations

import enum
import json
import os
import time

import torch

from ..observability.tracing import get_tracer as _host_tracer
from .phases import PHASES, PhaseAccountant, get_phase_accountant

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result",
           "export_protobuf",
           "SortedKeys", "SummaryView", "benchmark",
           "PHASES", "PhaseAccountant", "get_phase_accountant"]


class ProfilerState(enum.Enum):
    """reference: profiler/profiler.py:89."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class SortedKeys(enum.Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class RecordEvent:
    """Annotated host range, visible in the torch.profiler trace AND
    recorded as a span in the observability tracer, so summary()
    aggregates it and the exported host trace shows it with parent/child
    nesting. reference: python/paddle/profiler/utils.py RecordEvent."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._rf = None
        self._span = None

    def begin(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        # ungated tracer path: profiler users asked for recording
        # explicitly, independent of the global observability flag
        self._span = _host_tracer().begin(self.name)

    def end(self):
        if self._rf is not None:
            _host_tracer().end(self._span)
            self._span = None
            self._rf.__exit__(None, None, None)
            self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """reference: profiler/profiler.py make_scheduler — step-state machine."""
    cycle = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


class _ChromeTracingHandler:
    """on_trace_ready callback carrying the target dir: writes the
    torch.profiler trace (`<worker>.pt.trace.json`) and the host spans of
    this profiler run (`host_trace.<worker>.json`) there."""

    def __init__(self, dir_name, worker_name=None):
        self.log_dir = dir_name
        self.worker_name = worker_name
        self.last_trace = None
        self.last_host_trace = None
        os.makedirs(dir_name, exist_ok=True)

    def __call__(self, prof):
        worker = self.worker_name or str(os.getpid())
        if prof._prof is not None:
            self.last_trace = os.path.join(self.log_dir,
                                           f"{worker}.pt.trace.json")
            prof._prof.export_chrome_trace(self.last_trace)
        marker = getattr(prof, "_trace_marker", 0)
        self.last_host_trace = _host_tracer().export_chrome_trace(
            os.path.join(self.log_dir, f"host_trace.{worker}.json"), marker)


def export_chrome_tracing(dir_name, worker_name=None):
    """Traces land in dir_name, readable by chrome://tracing or Perfetto:
    the device trace plus the host_trace.*.json with the RecordEvent span
    tree."""
    return _ChromeTracingHandler(dir_name, worker_name)


def load_profiler_result(path):
    """A chrome trace written by export_chrome_tracing, as its JSON."""
    with open(path) as f:
        return json.load(f)


def _activities(targets):
    """torch.profiler activities for the targets: CPU and CUDA by
    default; CUDA raises where there is no card."""
    targets = (list(targets) if targets is not None
               else [ProfilerTarget.CPU, ProfilerTarget.GPU])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ProfilerTarget.GPU in targets:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Profiler traces the CUDA device by default and none is "
                "available; pass targets=[ProfilerTarget.CPU] to trace "
                "only the host")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """reference: python/paddle/profiler/profiler.py:358.

    with Profiler(targets=[...], scheduler=(2, 5)) as p:
        for batch in loader:
            train_step(batch)
            p.step()
    """

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        self._timer_only = timer_only
        self._activities = None if timer_only else _activities(targets)
        self._options = dict(record_shapes=record_shapes,
                             profile_memory=profile_memory,
                             with_flops=with_flops)
        self._log_dir = (getattr(on_trace_ready, "log_dir", None)
                         or os.environ.get("PADDLE_PROFILER_LOGDIR",
                                           "paddle_tpu_torch_profile"))
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self._scheduler = make_scheduler(closed=max(start, 0), ready=0,
                                             record=end - start, repeat=1)
        else:
            self._scheduler = None  # always record
        self._on_trace_ready = on_trace_ready
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._prof = None        # the torch.profiler.profile of the window
        self._tracing = False
        self._timer = benchmark()

    # -- state machine ------------------------------------------------------
    def _target_state(self):
        if self._scheduler is None:
            return ProfilerState.RECORD
        return self._scheduler(self._step)

    def _stop_trace(self):
        self._prof.stop()
        self._tracing = False
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def _sync(self):
        want = self._target_state()
        recording = want in (ProfilerState.RECORD,
                             ProfilerState.RECORD_AND_RETURN)
        if recording and not self._tracing and not self._timer_only:
            self._prof = torch.profiler.profile(
                activities=self._activities, **self._options)
            self._prof.start()
            self._tracing = True
        if not recording and self._tracing:
            self._stop_trace()
        self._state = want

    def start(self):
        # tracer watermark: summary()/host trace report only spans
        # recorded during THIS profiler run
        self._trace_marker = _host_tracer().marker()
        self._timer.begin()
        self._sync()
        return self

    def stop(self):
        if self._tracing:
            self._stop_trace()
        self._state = ProfilerState.CLOSED

    def step(self, num_samples=None):
        self._timer.step(num_samples)
        self._step += 1
        self._sync()

    def step_info(self, unit="samples"):
        return self._timer.step_info(unit)

    def events(self):
        """The last recorded window's events as plain dicts: name,
        device ("cpu" or "cuda"; a kernel is "cuda"), start and duration
        in microseconds, read from the trace's raw records. What
        `export_protobuf` writes."""
        if self._prof is None:
            return []
        cuda = torch.autograd.DeviceType.CUDA
        return [{"name": e.name(),
                 "device": "cuda" if e.device_type() == cuda else "cpu",
                 "start_us": e.start_ns() / 1e3,
                 "duration_us": e.duration_ns() / 1e3}
                for e in self._prof.profiler.kineto_results.events()]

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- reporting ----------------------------------------------------------
    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms"):
        """Host-event summary table, aggregated from the observability
        tracer's spans (device kernels are in the torch.profiler trace;
        reference: profiler_statistic.py)."""
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}[time_unit]
        marker = getattr(self, "_trace_marker", 0)
        rows = [(name, len(ds), sum(ds) * unit,
                 sum(ds) / len(ds) * unit, max(ds) * unit, min(ds) * unit)
                for name, ds in
                _host_tracer().durations_by_name(marker).items() if ds]
        rows.sort(key=lambda r: -r[2])
        header = (f"{'Name':<40}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
                  f"{'Avg':>12}{'Max':>12}{'Min':>12}")
        lines = [header, "-" * len(header)]
        for r in rows:
            lines.append(f"{r[0]:<40}{r[1]:>8}{r[2]:>14.3f}{r[3]:>12.3f}"
                         f"{r[4]:>12.3f}{r[5]:>12.3f}")
        table = "\n".join(lines)
        print(table)
        return table


class benchmark:
    """Throughput timer. reference: python/paddle/profiler/timer.py
    (Benchmark: ips / step cost, `paddle.profiler.benchmark()`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._last = None
        self._steps = 0
        self._samples = 0
        self._durs = []

    def begin(self):
        self._t0 = self._last = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._durs.append(now - self._last)
        self._last = now
        self._steps += 1
        if num_samples:
            self._samples += num_samples

    def step_info(self, unit="samples"):
        if not self._durs:
            return "no steps recorded"
        durs = self._durs[max(0, len(self._durs) - 100):]
        avg = sum(durs) / len(durs)
        ips = (self._samples / self._steps / avg) if self._samples else 1.0 / avg
        return (f"avg step: {avg * 1e3:.2f} ms, ips: {ips:.2f} {unit}/s "
                f"(last {len(durs)} steps)")

    def end(self):
        pass


def export_protobuf(profiler_result=None, path="profile.pb"):
    """Write a profiler's events as the reference's length-prefixed record
    (paddle_tpu/profiler/__init__.py:304-326): the byte length of the
    pickle as 8 little-endian bytes, then the pickle (protocol 4) of the
    events. `profiler_result` is a Profiler (its `events()`), or anything
    with an `events` attribute or method, or the events themselves."""
    import pickle
    if profiler_result is None:
        raise ValueError(
            "export_protobuf needs a profiler result (e.g. a Profiler's "
            "collected events); got None")
    events = getattr(profiler_result, "events", None)
    if events is None:
        events = profiler_result
    if callable(events):
        events = events()
    try:
        data = pickle.dumps(events, protocol=4)
    except Exception:  # noqa: BLE001 - keep plain data only
        data = pickle.dumps(repr(events), protocol=4)
    with open(path, "wb") as f:
        f.write(len(data).to_bytes(8, "little"))
        f.write(data)
    return path

"""The port's profiler (profiler/__init__.py) against the JAX package's,
mirroring tests/test_quant_infer_profiler.py's TestProfiler and its
chrome-tracing regression.

The state machine, the throughput timer and the host-span summary are the
reference's logic, so they give the reference's states and tables.
Device tracing is torch.profiler, which here, without a card, is asked for
the CPU only (`targets=[ProfilerTarget.CPU]`): the default asks for CUDA
too and raises without one.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu_torch import profiler
from paddle_tpu_torch.profiler import (ProfilerState, ProfilerTarget,
                                       benchmark, make_scheduler)
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = [ProfilerTarget.CPU]


class TestProfiler:
    def test_scheduler_states(self):
        sched = make_scheduler(closed=1, ready=1, record=2, repeat=1,
                               skip_first=1)
        states = [sched(i) for i in range(6)]
        assert states[0] == ProfilerState.CLOSED     # skip_first
        assert states[1] == ProfilerState.CLOSED
        assert states[2] == ProfilerState.READY
        assert states[3] == ProfilerState.RECORD
        assert states[4] == ProfilerState.RECORD_AND_RETURN
        assert states[5] == ProfilerState.CLOSED     # repeat exhausted

    def test_record_event_and_summary(self):
        with profiler.RecordEvent("unit_test_range"):
            _ = torch.ones(4, 4).sum()
        p = profiler.Profiler(timer_only=True)
        p.start()
        for _ in range(3):
            with profiler.RecordEvent("unit_test_range"):
                pass
            p.step(num_samples=8)
        info = p.step_info()
        assert "ips" in info
        table = p.summary()
        assert "unit_test_range" in table
        p.stop()

    def test_benchmark_timer(self):
        b = benchmark()
        b.begin()
        for _ in range(5):
            b.step(num_samples=4)
        assert "ips" in b.step_info()


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=1, skip_first=1),
    dict(closed=0, ready=0, record=3),
    dict(closed=2, ready=1, record=1, repeat=2),
])
def test_scheduler_equals_reference(kw):
    mine = make_scheduler(**kw)
    theirs = jprofiler.make_scheduler(**kw)
    assert [mine(i).name for i in range(12)] == \
        [theirs(i).name for i in range(12)]


def test_enums_equal_reference():
    for name in ("ProfilerState", "ProfilerTarget", "SortedKeys",
                 "SummaryView"):
        mine, theirs = getattr(profiler, name), getattr(jprofiler, name)
        assert [(m.name, m.value) for m in mine] == \
            [(m.name, m.value) for m in theirs]


def test_chrome_tracing_dir_used(tmp_path):
    d = str(tmp_path / "trace_out")
    handler = profiler.export_chrome_tracing(d)
    p = profiler.Profiler(on_trace_ready=handler, timer_only=True)
    assert p._log_dir == d


def test_trace_holds_record_events(tmp_path):
    """A traced window (scheduler (1, 3): steps 1 and 2 record) writes the
    torch.profiler trace and the host spans; the RecordEvent ranges are
    in both."""
    handler = profiler.export_chrome_tracing(str(tmp_path), "w0")
    x = torch.ones(32, 32)
    with profiler.Profiler(targets=CPU, scheduler=(1, 3),
                           on_trace_ready=handler) as p:
        for _ in range(5):
            with profiler.RecordEvent("step_body"):
                x = x @ torch.ones(32, 32) / 32
            p.step()
    trace = profiler.load_profiler_result(handler.last_trace)
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("step_body") == 2
    host = profiler.load_profiler_result(handler.last_host_trace)
    assert any(e.get("name") == "step_body" for e in host["traceEvents"])


def test_default_targets_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.Profiler()


def test_step_info_matches_reference_format():
    mine, theirs = benchmark(), jprofiler.benchmark()
    assert mine.step_info() == theirs.step_info() == "no steps recorded"
    for b in (mine, theirs):
        b.begin()
        for _ in range(3):
            b.step(num_samples=2)
    for info in (mine.step_info("tokens"), theirs.step_info("tokens")):
        assert info.startswith("avg step: ") and "tokens/s" in info
        assert info.endswith("(last 3 steps)")
    assert np.isfinite(float(mine.step_info().split("ips: ")[1].split()[0]))

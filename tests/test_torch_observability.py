"""The port's observability layer and profiler phase accountant against the
JAX package's.

The modules are copies of pure-Python modules, so parity means equal
outputs on equal inputs: the same calls go to a registry, tracer,
recorder, SLO engine, sampler or advisor of each package, and the
Prometheus text, snapshots, span trees, verdicts and summaries must match
with the timing fields (wall clocks, durations) left out. The port's
`generate` and attention router must count and trace as the reference's
do.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import observability as jobs
from paddle_tpu.profiler import phases as jphases
import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.profiler import phases
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (jobs, obs)


@pytest.fixture
def both_enabled():
    for o in BOTH:
        o.get_registry().reset()
        o.get_tracer().clear()
        o.enable()
    yield
    for o in BOTH:
        o.disable()
        o.get_registry().reset()
        o.get_tracer().clear()


def _drive_registry(o):
    """The same calls on a fresh registry of package `o`."""
    reg = o.MetricRegistry(enabled=True)
    c = reg.counter("requests_total", "requests by route", ("route",))
    c.labels(route="a").inc()
    c.labels(route="b").inc(3)
    g = reg.gauge("queue_depth", "queued requests")
    g.set(7)
    g.inc(2)
    g.dec()
    h = reg.histogram("latency_seconds", "latency", ("route",),
                      buckets=(0.01, 0.1, 1.0))
    for v, ex in ((0.005, "t1"), (0.05, None), (0.5, "t2"), (5.0, "t3")):
        h.labels(route="a").observe(v, exemplar=ex)
    h.labels(route="b").observe(0.2)
    return reg


def _untimed(doc):
    doc = dict(doc)
    doc.pop("recorded_unix", None)
    return doc


def test_catalog_is_the_reference_catalog():
    assert obs.CATALOG == jobs.CATALOG


def test_registry_text_and_snapshot_match():
    ref, port = (_drive_registry(o) for o in BOTH)
    assert (obs.metrics.to_prometheus_text(port)
            == jobs.metrics.to_prometheus_text(ref))
    snap = obs.metrics.snapshot(port, meta={"run": 1})
    assert _untimed(snap) == _untimed(jobs.metrics.snapshot(
        ref, meta={"run": 1}))
    back = obs.load_snapshot(json.dumps(snap))
    assert (obs.metrics.to_prometheus_text(back)
            == obs.metrics.to_prometheus_text(port))


def test_disabled_registry_records_nothing():
    for o in BOTH:
        reg = o.MetricRegistry(enabled=False)
        reg.counter("x_total").inc()
        assert reg.get("x_total").value == 0


def test_quantiles_match():
    rs = np.random.RandomState(0)
    sample = list(rs.exponential(0.2, 500))
    reg = obs.MetricRegistry(enabled=True)
    h = reg.histogram("h", buckets=(0.05, 0.1, 0.2, 0.5, 1.0, 2.0))
    for v in sample:
        h.observe(v)
    buckets = h.cumulative_buckets()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert (obs.quantile_from_cumulative(buckets, q)
                == jobs.quantile_from_cumulative(buckets, q))
    assert (obs.quantiles_from_cumulative(buckets)
            == jobs.quantiles_from_cumulative(buckets))
    doc = obs.metrics.snapshot(reg)["metrics"][0]["samples"][0]
    assert (obs.quantiles.quantiles_from_sample(doc)
            == jobs.quantiles.quantiles_from_sample(doc))


def _span_tree(o):
    tr = o.Tracer(enabled=True)
    with tr.span("serving.step", k=4):
        with tr.span("serving.prefill", rid=1, trace_id="req-1"):
            pass
        with tr.span("serving.decode_step", active=2):
            pass
    tr.add_span("request.decode.tile", 1000, 500, trace_id="req-1",
                tid=o.tracing.LANE_TID_BASE + 1, tid_name="lane 1",
                args={"tile": 0}, links=["req-1", "req-2"])
    events = tr.chrome_trace_events()
    for e in events:
        for key in ("ts", "dur", "pid"):
            e.pop(key, None)
        if e["ph"] == "X" and e["name"] != "request.decode.tile":
            e.pop("tid")            # the recording thread's id
        e.get("args", {}).pop("parent", None)
    return events, sorted(tr.durations_by_name())


def test_tracer_span_trees_match():
    assert _span_tree(obs) == _span_tree(jobs)
    for o in BOTH:
        assert o.Tracer(enabled=False).span("x") is o.Tracer(
            enabled=False).span("y")          # the shared no-op


def test_flight_recorder_matches(tmp_path):
    out = []
    for o in BOTH:
        rec = o.FlightRecorder(enabled=True, capacity=4)
        for i in range(6):
            rec.record("dispatch" if i % 2 else "admit", rid=i, lane=i % 3)
        events = [{k: v for k, v in e.items() if k not in ("t", "t_ns",
                                                           "ts")}
                  for e in rec.events()]
        path = rec.dump(str(tmp_path / f"{o.__name__}.json"), reason="test")
        out.append((events, rec.counts_by_kind(), rec.total_recorded,
                    len(rec), o.recorder.validate_dump(path)))
    assert out[0] == out[1]


def _snapshots(o):
    """Two snapshots of a serving registry, 60 s apart."""
    reg = o.MetricRegistry(enabled=True)
    o.catalog.register_all(reg)
    ttft = reg.get("serving_ttft_seconds")
    fin = reg.get("serving_finished_total")
    docs = []
    for wave in range(2):
        for v in np.linspace(0.05, 3.0 + wave, 40):
            ttft.observe(float(v))
        fin.labels(reason="length").inc(30)
        fin.labels(reason="shed").inc(2 + 5 * wave)
        docs.append(o.metrics.snapshot(reg))
    return docs


def test_slo_engine_verdicts_match():
    out = []
    for o in BOTH:
        eng = o.SLOEngine(window_s=120.0)
        for t, doc in zip((0.0, 60.0), _snapshots(o)):
            eng.observe(doc, t)
        out.append(eng.evaluate(emit=False))
    assert out[0] == out[1]


def test_metrics_sampler_matches():
    out = []
    for o in BOTH:
        docs = iter(_snapshots(o) * 2)
        smp = o.MetricsSampler(scrape=lambda: next(docs), retention=8)
        for t in (0.0, 10.0, 20.0, 30.0):
            smp.sample(now=t)
        out.append((smp.summary(), {r: smp.rule_latest(r)
                                    for r in o.RECORDING_RULES}))
    assert out[0] == out[1]


def test_autoscale_advice_matches():
    out = []
    for o in BOTH:
        adv = o.AutoscaleAdvisor()
        verdicts = [adv.advise(current_replicas=n, headroom_min=hm,
                               headroom_sum=hs, burn_rate=br)
                    for n, hm, hs, br in ((2, 0.05, 0.3, 0.5),
                                          (3, 0.6, 2.5, 0.1),
                                          (1, 0.3, 0.3, 2.0))]
        out.append((verdicts, [o.autoscale.check_verdict(v)
                               for v in verdicts]))
    assert out[0] == out[1]


def test_stepwatch_rows_match(both_enabled, tmp_path, monkeypatch):
    rows = []
    for o in BOTH:
        # a default registry of the test's own: a reset keeps the metric
        # families earlier tests defined (the reference's supervisor
        # defines train_nonfinite_skips_total), and those would be listed
        monkeypatch.setattr(o.metrics, "_default_registry",
                            o.MetricRegistry(enabled=True))
        path = tmp_path / f"{o.__name__}.jsonl"
        sw = o.StepWatch(tokens_per_step=1024, flops_per_token=6e9,
                         peak_flops=1e15, jsonl_path=str(path),
                         run_name="tiny", round=6)
        sw.record_run(steps=4, seconds=2.0, tokens=4096, loss=1.5)
        rows.append(([{k: v for k, v in json.loads(line).items()
                       if k not in ("t", "ts", "unix", "time")}
                      for line in path.read_text().splitlines()],
                     [m for m in o.metrics.snapshot(o.get_registry())[
                         "metrics"] if m["name"].startswith("train_")]))
    assert rows[0] == rows[1]


def test_phase_accountant_matches():
    assert phases.PHASES == jphases.PHASES
    out = []
    for mod in (jphases, phases):
        acc = mod.PhaseAccountant(enabled=True)
        acc.begin_step()
        acc.mark("admit", dt=0.0)
        acc.mark("prefill.chunk", tenant="a", dt=0.0)
        acc.credit_tenants(["a", "b"], 0.5)
        acc.end_step()
        with pytest.raises(KeyError, match="unknown profiler phase"):
            acc.mark("nope")
        rep = acc.report()
        out.append(({p: v["marks"] for p, v in rep["phases"].items()},
                    rep["steps"], sorted(rep["tenants"])))
    assert out[0] == out[1]


def test_flag_turns_the_layer_on_and_off():
    pt.set_flags({"FLAGS_observability": True})
    try:
        assert obs.enabled() and obs.get_tracer().enabled
    finally:
        pt.set_flags({"FLAGS_observability": False})
    assert not obs.enabled()
    env = dict(os.environ, FLAGS_observability="1")
    env.pop("PYTHONPATH", None)
    probe = subprocess.run(
        [sys.executable, "-c", "import paddle_tpu_torch.observability as o; "
         "print(o.enabled())"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert probe.stdout.strip() == "True", probe.stderr
    assert (pt.get_flags(["observability", "flight_recorder_dir",
                          "fault_injection"])
            == {"observability": False, "flight_recorder_dir": "",
                "fault_injection": ""})


def test_generate_counts_and_traces_as_the_reference(both_enabled):
    paddle.seed(0)
    ref = paddle.models.llama_tiny(num_hidden_layers=1)
    port = pt.models.llama_tiny(num_hidden_layers=1, device="cpu")
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    ids = np.ones((2, 4), np.int64)
    jgen.generate(ref, paddle.to_tensor(ids.astype(np.int32)),
                  max_new_tokens=3)
    generation.generate(port, torch.as_tensor(ids), max_new_tokens=3)
    counts = [o.get_registry().get("generation_requests_total").children()
              for o in BOTH]
    assert ({k: c.value for k, c in counts[1].items()}
            == {k: c.value for k, c in counts[0].items()})
    names = [{s.name: (s.parent, s.args) for s in o.get_tracer().spans_since()}
             for o in BOTH]
    # the reference's extra span times its jit build (first call only)
    names[0].pop("generation.build")
    assert set(names[1]) == set(names[0]) == {"generation.generate",
                                              "generation.prefill_decode"}
    g_port, g_ref = (n["generation.generate"] for n in names[::-1])
    assert g_port == g_ref


def test_generic_generate_counts_and_traces_as_the_reference(both_enabled):
    """GPT takes the recompute path in both packages: one
    generation_requests_total{path="generic_recompute"} and a
    generation.generate span over one generation.decode_step a token."""
    paddle.seed(0)
    ref = paddle.models.gpt_tiny(num_hidden_layers=1)
    port = pt.models.gpt_tiny(num_hidden_layers=1, device="cpu")
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    ids = np.ones((2, 4), np.int64)
    jgen.generate(ref, paddle.to_tensor(ids.astype(np.int32)),
                  max_new_tokens=2)
    generation.generate(port, torch.as_tensor(ids), max_new_tokens=2)
    counts = [{k: c.value for k, c in o.get_registry().get(
        "generation_requests_total").children().items()} for o in BOTH]
    assert counts[1] == counts[0] and sum(counts[1].values()) == 1
    spans = [[(s.name, s.args) for s in o.get_tracer().spans_since()]
             for o in BOTH]
    assert sorted(n for n, _ in spans[1]) == sorted(n for n, _ in spans[0])
    assert [n for n, _ in spans[1]].count("generation.decode_step") == 2
    assert dict(spans[1])["generation.generate"] == \
        dict(spans[0])["generation.generate"]


def test_router_counts_fresh_decisions_by_source(both_enabled):
    from paddle_tpu.ops.pallas import attention_router as jar
    from paddle_tpu_torch.ops import attention_router as ar
    for r in (ar, jar):
        r.clear_routing_cache()
    try:
        for bh in (8, 8, 16):               # the repeat is a cache hit
            ar.route(bh, 64, 64, 64, torch.float32, True, platform="cpu",
                     device_kind="cpu")
            jar.route(bh, 64, 64, 64, "float32", True, platform="cpu",
                      device_kind="cpu")
        # series at 0 are left from earlier tests in the same process
        counts = [{k: c.value for k, c in o.get_registry().get(
            "attention_router_decisions_total").children().items()
            if c.value} for o in BOTH]
        assert counts[1] == counts[0] and sum(counts[1].values()) == 2
    finally:
        for r in (ar, jar):
            r.clear_routing_cache()

"""The port's traffic harness (inference/loadgen.py) and the engine's cost
model (pir/analysis.py) against the JAX package's, mirroring
tests/test_loadgen_profiler.py.

loadgen.py is a copy of a jax-free module: a (scenario, seed) pair gives
the reference's schedule digest for digest. A drained chat run through the
port's engine gives, request for request, the greedy stream the reference
engine gives for the same prompt and length (f32, the reference's weights
through convert.py). The reference's harness cases (a chat run that
passes check_report, the tenant snapshot round trip, headroom leading
shed, the scheduler engaging before shed, the saturation sweep, the cost
model's transfer across blocks) run on the port, and the engine's priced
programs are held against the reference's CostModel on the same tiny
config.

The harness runs on the wall clock. Each test here runs torch on one
thread: the tiny model gains nothing from more, and a worker's threads
compete with the other workers' processes under xdist. Tolerances and
bands are the reference tests' own.
"""

import collections
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import loadgen as jloadgen
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.pir import analysis as janalysis
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine, loadgen
from paddle_tpu_torch.inference.loadgen import (SCENARIOS, Scenario,
                                                build_schedule, check_report,
                                                run_scenario, schedule_digest)
from paddle_tpu_torch.inference.scheduler import SLOScheduler
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.pir.analysis import (DEFAULT_ROOFLINE, ProgramCost,
                                             _captured_cost, price)
from paddle_tpu_torch.pir.pipeline import CompileReport
from paddle_tpu_torch.profiler.phases import PHASES, get_phase_accountant

WIDTHS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=256)
_PAIR = []


def _pair():
    """(reference model, port model with the reference's weights), f32."""
    if not _PAIR:
        paddle.seed(0)
        ref = JLlama(JConfig(**WIDTHS))
        port = LlamaForCausalLM(LlamaConfig(**WIDTHS), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _PAIR.extend((ref, port))
    return _PAIR


def _model():
    return _pair()[1]


def _engine(model, Engine=ContinuousBatchingEngine, **kw):
    kw.setdefault("num_blocks", 128)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_buckets", (16, 32))
    kw.setdefault("max_queue", 64)
    return Engine(model, **kw)


def _saturable_engine(model):
    """An engine the chat scenario can drown: one lane, one decode step
    per dispatch, a short admission queue."""
    return _engine(model, max_batch=1, decode_steps=1, max_queue=8)


def _warm(eng):
    """Price and calibrate the cost model and run both chat prefill
    widths before a run."""
    eng.add_request(np.arange(7) % 128, max_new_tokens=4)
    eng.add_request(np.arange(20) % 128, max_new_tokens=4)
    eng.run()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_new_series():
    """Every test here leaves both packages' registries without the
    labelled series it created, so the counter sets other files' tests
    compare do not depend on the order the files run in."""
    regs = (obs.get_registry(), jobs.get_registry())
    before = {id(m): set(m._children) for r in regs for m in r.collect()}
    yield
    for m in (m for r in regs for m in r.collect()):
        for key in set(m._children) - before.get(id(m), {()}):
            del m._children[key]


def _obs_on():
    obs.get_registry().reset()
    obs.enable()
    acct = get_phase_accountant()
    acct.reset()
    acct.enable()


def _obs_off():
    acct = get_phase_accountant()
    acct.disable()
    acct.reset()
    obs.disable()
    obs.get_registry().reset()


@pytest.fixture
def enabled_obs():
    _obs_on()
    yield obs
    _obs_off()


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(jloadgen.SCENARIOS))
def test_schedule_digest_equals_reference(name, seed):
    mine = build_schedule(SCENARIOS[name], seed=seed)
    theirs = jloadgen.build_schedule(jloadgen.SCENARIOS[name], seed=seed)
    assert mine == theirs
    assert schedule_digest(mine) == jloadgen.schedule_digest(theirs)


def test_scenarios_and_report_format_equal_reference():
    assert sorted(SCENARIOS) == sorted(jloadgen.SCENARIOS)
    for name, sc in SCENARIOS.items():
        ref = jloadgen.SCENARIOS[name]
        assert {s: getattr(sc, s) for s in Scenario.__slots__} == \
            {s: getattr(ref, s) for s in Scenario.__slots__}
    assert loadgen.REPORT_FORMAT == jloadgen.REPORT_FORMAT == 2
    assert loadgen.KNOWN_FINISH_REASONS == jloadgen.KNOWN_FINISH_REASONS


class TestScheduleDeterminism:
    def test_same_seed_same_schedule(self):
        for name in sorted(SCENARIOS):
            s1 = build_schedule(SCENARIOS[name], seed=7)
            s2 = build_schedule(SCENARIOS[name], seed=7)
            assert s1 == s2, name
            assert schedule_digest(s1) == schedule_digest(s2)
            assert s1, f"{name}: empty schedule"
            assert all(a["t"] <= b["t"] for a, b in zip(s1, s1[1:]))

    def test_different_seeds_differ(self):
        a = build_schedule(SCENARIOS["chat"], seed=0)
        b = build_schedule(SCENARIOS["chat"], seed=1)
        assert schedule_digest(a) != schedule_digest(b)

    def test_overrides_shape_the_schedule(self):
        short = build_schedule(SCENARIOS["chat"], seed=0, duration_s=0.5)
        full = build_schedule(SCENARIOS["chat"], seed=0)
        assert max(a["t"] for a in short) < 0.5
        assert len(short) < len(full)
        dense = build_schedule(SCENARIOS["chat"], seed=0, rate_rps=60.0)
        assert len(dense) > len(full)


# -- a drained chat run against the reference engine --------------------------

def test_drained_chat_streams_equal_reference_engine(enabled_obs):
    """chat at seed 0 (chat's schedule), with no deadline so the wall
    clock cannot cut a stream: every request's greedy stream equals the
    one the reference engine gives the same prompt and length, all queued
    up front."""
    chat = SCENARIOS["chat"]
    sc = Scenario("chat", **{
        s: getattr(chat, s) for s in Scenario.__slots__
        if s not in ("name", "deadline_s")})
    eng = _engine(_model(), max_queue=None)
    report = run_scenario(eng, sc, seed=0, sample_every_s=0.1)
    assert report["finished"] == {"length": report["issued"]}
    got = [eng.finished[rid].generated for rid in sorted(eng.finished)]

    schedule = jloadgen.build_schedule(sc, seed=0)
    assert jloadgen.schedule_digest(schedule) == jloadgen.schedule_digest(
        jloadgen.build_schedule(jloadgen.SCENARIOS["chat"], seed=0))
    ref = _engine(_pair()[0], JEngine, max_queue=None)
    vocab = WIDTHS["vocab_size"]
    rids = [ref.add_request(
        jloadgen._prompt_tokens(a["prompt_seed"], a["prompt_len"], vocab),
        max_new_tokens=a["output_tokens"], seed=a["sample_seed"])
        for a in schedule]
    out = ref.run()
    want = [out[r] for r in rids]
    assert len(got) == len(want) == len(schedule)
    assert got == want


# -- the harness's cases (test_loadgen_profiler.py) ---------------------------

@pytest.fixture(scope="module")
def chat_report():
    """One real harness run shared by the report-shape assertions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _obs_on()
    try:
        eng = _engine(_model())
        report = run_scenario(eng, "chat", seed=0, duration_s=1.0,
                              sample_every_s=0.1)
        snap = obs.metrics.snapshot(obs.get_registry())
        yield report, snap
    finally:
        _obs_off()
        torch.set_num_threads(n)


class TestChatRun:
    def test_check_report_passes(self, chat_report):
        report, _snap = chat_report
        assert check_report(report) == []
        assert report["issued"] > 0
        assert report["goodput"] == 1.0
        assert report["mesh"] is None

    def test_slo_verdict_present(self, chat_report):
        report, _snap = chat_report
        assert isinstance(report["slo"], dict)
        assert "ok" in report["slo"]
        assert {s["name"] for s in report["slo"]["slos"]} >= {
            "ttft_p95", "tpot_p99"}

    def test_attribution_coverage(self, chat_report):
        report, _snap = chat_report
        assert report["coverage"] >= 0.95
        marked = set(report["phases"]["phases"])
        assert marked <= set(PHASES)
        # the serving hot path must exercise the core phases
        assert {"admit", "decode.dispatch", "commit", "compile"} <= marked

    def test_cost_ratio_populated(self, chat_report):
        report, _snap = chat_report
        assert report["cost"]["ratio"], "no pir_cost_ratio samples"
        assert report["cost"]["programs"]
        assert all(c["seconds"] is not None
                   for c in report["cost"]["programs"].values())

    def test_tenant_metrics_emitted(self, chat_report):
        report, snap = chat_report
        assert set(report["tenants"]) >= {"acme", "zee"}
        labelled = set()
        for m in snap["metrics"]:
            if m["name"] == "serving_tenant_finished_total":
                for s in m["samples"]:
                    labelled.add(s["labels"].get("tenant"))
        assert {"acme", "zee"} <= labelled


class TestCostModelTransfer:
    def test_ratio_within_band_across_blocks(self):
        """Calibrate the roofline scale on one block priced by `price`,
        predict a wider one: measured/predicted must land in [0.2, 5]."""
        def make(width):
            rs = np.random.RandomState(width)
            x, w1, w2 = (torch.tensor(rs.randn(width, width),
                                      dtype=torch.float32)
                         for _ in range(3))

            def block():
                return torch.tanh(x @ w1) @ w2

            _out, cost = price(block, name=f"cost_block_{width}")
            assert cost.raw_seconds > 0

            def measure():
                block()  # warm
                best = float("inf")
                for _ in range(5):
                    t0 = time.perf_counter()
                    block()
                    best = min(best, time.perf_counter() - t0)
                return best

            return cost.raw_seconds, measure()

        raw_a, meas_a = make(256)
        raw_b, meas_b = make(512)
        scale = meas_a / raw_a          # calibrate on A
        ratio = meas_b / (raw_b * scale)
        assert 0.2 <= ratio <= 5.0, (
            f"cost model transfer off the rails: ratio={ratio:.3f} "
            f"(raw_a={raw_a:.3g} meas_a={meas_a:.3g} "
            f"raw_b={raw_b:.3g} meas_b={meas_b:.3g})")


class TestTenantSnapshotRoundTrip:
    def test_per_label_counts_survive(self):
        reg = obs.get_registry()
        reg.reset()
        obs.enable()
        try:
            from paddle_tpu_torch.observability.catalog import metric
            for _ in range(3):
                metric("serving_tenant_ttft_seconds",
                       tenant="acme").observe(0.05)
            metric("serving_tenant_ttft_seconds", tenant="zee").observe(1.5)
            metric("serving_tenant_finished_total",
                   tenant="acme", reason="eos").inc()
            doc = obs.metrics.snapshot(reg)
            reg2 = obs.metrics.load_snapshot(doc)
            by_name = {m.name: m for m in reg2.collect()}
            hist = by_name["serving_tenant_ttft_seconds"].children()
            acme = hist[(("tenant", "acme"),)]
            zee = hist[(("tenant", "zee"),)]
            assert acme.count == 3 and abs(acme.sum - 0.15) < 1e-9
            assert zee.count == 1 and abs(zee.sum - 1.5) < 1e-9
            ctr = by_name["serving_tenant_finished_total"].children()
            assert ctr[(("reason", "eos"),
                        ("tenant", "acme"))].value == 1
        finally:
            obs.disable()
            reg.reset()

    def test_tenant_cardinality_is_bounded(self):
        eng = _engine(_model(), max_queue=None)
        eng._max_tenants = 4
        prompt = np.arange(5) % 128
        for i in range(6):
            eng.add_request(prompt, max_new_tokens=1, tenant=f"t{i}")
        seen = {r.tenant for r in eng.queue}
        assert "overflow" in seen
        assert len({t for t in seen if t != "overflow"}) == 4


def _first(tl, pred):
    return next((i for i, s in enumerate(tl) if pred(s)), len(tl))


class TestOverloadOrdering:
    def test_headroom_flips_before_shed(self, enabled_obs):
        """Leading vs lagging: past saturation the cost-model headroom
        goes non-positive no later than shed fraction crossing 10%."""
        eng = _saturable_engine(_model())
        _warm(eng)
        assert eng.predicted_service_seconds(output_tokens=8) is not None

        report = run_scenario(eng, "chat", seed=2, rate_rps=400.0,
                              duration_s=0.5, drain=False,
                              sample_every_s=0.05)
        assert report["headroom_floor"] is not None
        assert report["headroom_floor"] <= 0.0
        tl = report["timeline"]
        over_idx = _first(tl, lambda s: s["headroom"] is not None
                          and s["headroom"] <= 0.0)
        shed_idx = _first(tl, lambda s: s["shed_frac"] > 0.10)
        assert over_idx <= shed_idx, (
            f"overload gauge lagged the shed signal: headroom flipped at "
            f"sample {over_idx}, shed>10% at {shed_idx}")
        assert report["shed"] > 0      # the overload was real

    def test_scheduler_engages_before_shed(self, enabled_obs):
        """With the SLO scheduler attached, the closed loop ACTS
        (brownout level > 0 or a preemption) no later than the sample
        where shed fraction crosses 10%."""
        eng = _engine(_model(), max_batch=1, decode_steps=1, max_queue=8,
                      scheduler=SLOScheduler(ttft_target=1e9,
                                             tpot_target=1e9,
                                             escalate_after=1,
                                             min_dwell=0))
        _warm(eng)
        assert eng.predicted_service_seconds(output_tokens=8) is not None

        report = run_scenario(eng, "chat", seed=2, rate_rps=400.0,
                              duration_s=0.5, drain=False,
                              sample_every_s=0.05)
        tl = report["timeline"]
        engage_idx = _first(tl, lambda s: (s.get("brownout") or 0) > 0
                            or (s.get("preemptions") or 0) > 0)
        shed_idx = _first(tl, lambda s: s["shed_frac"] > 0.10)
        assert engage_idx < len(tl), "scheduler never engaged"
        assert engage_idx <= shed_idx, (
            f"scheduler lagged the shed signal: engaged at sample "
            f"{engage_idx}, shed>10% at {shed_idx}")
        assert eng.scheduler.transitions_up > 0


class TestSaturationSweep:
    def test_goodput_degrades_after_headroom(self, enabled_obs):
        """Sweep offered rate across saturation: the low rate is healthy,
        the highest sheds more, and headroom went non-positive at a rate
        no higher than where shedding took off."""
        rows = []
        for rate in (5.0, 25.0, 400.0):
            eng = _saturable_engine(_model())
            _warm(eng)
            rep = run_scenario(eng, "chat", seed=0, rate_rps=rate,
                               duration_s=0.5, drain=(rate <= 5.0),
                               sample_every_s=0.05)
            attempts = rep["issued"] + rep["rejected"]
            rows.append({"rate": rate,
                         "shed_frac": rep["shed"] / max(1, attempts),
                         "floor": rep["headroom_floor"]})
        assert rows[0]["shed_frac"] <= 0.05     # healthy at low rate
        assert rows[-1]["shed_frac"] > rows[0]["shed_frac"]
        over = [r["rate"] for r in rows
                if r["floor"] is not None and r["floor"] <= 0.0]
        shedding = [r["rate"] for r in rows if r["shed_frac"] > 0.10]
        assert over, "headroom never went non-positive in the sweep"
        if shedding:
            assert min(over) <= min(shedding)


# -- the engine's cost model --------------------------------------------------

def test_calibrated_after_warm_up():
    """The engine prices its programs and its first measured dispatch
    calibrates them: the scheduler and loadgen get a service time."""
    eng = _engine(_model())
    assert eng.predicted_service_seconds(8) is None
    _warm(eng)
    svc = eng.predicted_service_seconds(8)
    assert svc is not None and svc > 0
    costs = eng.predicted_costs()
    assert set(costs) == {"prefill.b16", "prefill.b32", "decode"}
    assert all(c["seconds"] > 0 and c["flops"] > 0 and c["bytes"] > 0
               for c in costs.values())
    # on the CPU every program is eager: one scale, as the reference's
    assert set(eng._cost_scale) == {"eager"}
    assert eng._cost_scale["eager"] > 0


def test_each_kind_of_program_has_its_own_scale_on_the_card():
    """On the card a decode replays a captured graph and a prefill chunk
    runs eagerly: each kind is calibrated by its own measured dispatches
    (the first sets the scale, the median of the first three holds it),
    and the service time waits for both. Driven through the engine's
    bookkeeping with its device set to CUDA (nothing runs)."""
    eng = _engine(_model())
    eng.device = torch.device("cuda")

    def report(name, raw):
        rep = CompileReport(name)
        rep.cost = ProgramCost(name, 1.0, 1.0, raw, [])
        return rep
    eng.compile_reports = {
        "decode": report("decode", 1e-3),
        "decode.sampled": report("decode.sampled", 2e-3),
        "prefill.b16": report("prefill.b16", 1e-4),
        "prefill.b32": report("prefill.b32", 2e-4)}
    eng._cost_observe("decode", 3e-3)              # graph: 3
    assert eng._cost_scale == {"graph": pytest.approx(3.0)}
    assert eng.predicted_costs()["prefill.b16"]["seconds"] is None
    assert eng.predicted_service_seconds(8) is None
    eng._cost_observe("prefill.b16", 5e-3)         # eager: 50
    assert eng._cost_scale == {"graph": pytest.approx(3.0),
                               "eager": pytest.approx(50.0)}
    costs = eng.predicted_costs()
    assert costs["decode.sampled"]["seconds"] == pytest.approx(6e-3)
    assert costs["prefill.b32"]["seconds"] == pytest.approx(1e-2)
    # 8 tokens are 2 dispatches of decode_steps 4, shared by max_batch 4
    # lanes, plus the first prefill width's chunk
    assert eng.predicted_service_seconds(8) == pytest.approx(
        2 * 3e-3 / 4 + 5e-3)
    # the next two dispatches of a kind refine its scale to the median,
    # and later ones move nothing
    eng._cost_observe("prefill.b32", 4e-2)         # eager: 50, 200
    assert eng._cost_scale["eager"] == pytest.approx(125.0)
    eng._cost_observe("prefill.b16", 7e-3)         # eager: 50, 200, 70
    assert eng._cost_scale["eager"] == pytest.approx(70.0)
    eng._cost_observe("prefill.b16", 1e-3)
    assert eng._cost_scale == {"graph": pytest.approx(3.0),
                               "eager": pytest.approx(70.0)}
    # loadgen's reset after its warm-up starts the calibration again
    eng._cost_scale = None
    eng._cost_observe("decode.sampled", 1e-2)      # graph: 5
    assert eng._cost_scale == {"graph": pytest.approx(5.0)}


def test_scheduler_sees_headroom_after_warm_up():
    eng = _engine(_model(), scheduler=SLOScheduler())
    _warm(eng)
    eng.add_request(np.arange(9) % 128, max_new_tokens=4)
    eng.step()
    assert eng.scheduler._last_sig.headroom is not None


def _reference_costs():
    """The reference engine's CostModel prices on the same config and
    traffic: {key: (total flops, dot_general flops)}, the products summed
    through the scanned bodies."""
    eng = _engine(_pair()[0], JEngine, prefill_buckets=(16, 32, 64))
    eng.add_request(np.arange(50) % 128, max_new_tokens=6)
    eng.run()
    out = {}
    for key, rep in eng.compile_reports.items():
        products = collections.Counter()

        def walk(eqns, mult):
            for eqn in eqns:
                inner = janalysis._inner_jaxprs(eqn.params)
                if inner:
                    trips = float(eqn.params.get("length", 1) or 1)
                    for j in inner:
                        walk(j.eqns, mult * trips)
                elif eqn.primitive.name == "dot_general":
                    products[key] += janalysis._eqn_cost(eqn)[0] * mult
        walk([op.eqn for op in rep.program.ops if op.eqn is not None], 1.0)
        out[key] = (rep.cost.flops, products[key])
    return out


def test_priced_flops_against_reference_cost_model():
    """The 64-wide prefill's priced flops are within 10% of the
    reference's (measured: -5.0%: the reference also prices its reshapes,
    which the port's views make free). The decode program does more
    arithmetic than the reference's by design: its paged attention
    multiplies block-diagonal queries [H, KVH * D] by the pages (KVH times
    the products of per-head ones, ops/paged_attention.py
    `_decode_attend`). Its priced matrix products equal the reference's
    dot_general flops plus exactly that excess (within 10%; measured:
    equal), and its total is 1.79x the reference's (23.1 against 12.9
    MFLOP) on this config. The port's programs are one layer's body,
    which a chunk replays once a layer and a decode tile once a layer and
    a step, where the reference scans its layer body and its step: their
    prices count that many times (the embedding lookup and the head, run
    as written around them, are left out). Products are counted inside
    fused regions too."""
    ref = _reference_costs()
    eng = _engine(_model(), prefill_buckets=(16, 32, 64))
    eng.add_request(np.arange(50) % 128, max_new_tokens=6)
    eng.run()
    mine = eng.compile_reports
    L, K = WIDTHS["num_hidden_layers"], eng.decode_steps
    flops = L * mine["prefill.b64"].cost.flops
    assert abs(flops / ref["prefill.b64"][0] - 1.0) <= 0.10, \
        (flops, ref["prefill.b64"])

    def product_flops(ops):
        total = 0.0
        for op in ops:
            body = getattr(op.fn, "body", None)
            if body is not None:
                total += product_flops(body[1])
            elif op.target is not None and \
                    op.target.overloadpacket.__name__ in ("mm", "bmm"):
                total += _captured_cost(op)[0]
        return total
    products = K * L * product_flops(mine["decode"].program.ops)
    # the block-diagonal excess: (KVH - 1) times the two per-head products
    # of 2 * D flops per (query head, position) over the gathered pages,
    # for every lane, layer and step
    B, H, KVH = eng.max_batch, 4, 4
    D = WIDTHS["hidden_size"] // H
    L = eng.max_blocks_per_seq * eng.pool.block_size
    excess = ((KVH - 1) * 2 * 2 * B * H * D * L
              * WIDTHS["num_hidden_layers"] * eng.decode_steps)
    assert abs((products - excess) / ref["decode"][1] - 1.0) <= 0.10, \
        (products, excess, ref["decode"])
    assert K * L * mine["decode"].cost.flops > ref["decode"][0]


def test_price_rule():
    """The reference's rule, op by op: a product costs 2 * out * K flops,
    anything else its output elements; bytes are inputs plus outputs; a
    view is free; raw seconds are the roofline's."""
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    out, cost = price(lambda: torch.relu(a @ b).t())
    assert out.shape == (4, 8)
    per_op = dict(cost.per_op)
    assert per_op["mm"].flops == 2 * 8 * 4 * 16
    assert per_op["mm"].bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert per_op["relu"].flops == 8 * 4
    assert "t" not in per_op and "transpose" not in per_op
    assert cost.flops == 2 * 8 * 4 * 16 + 8 * 4
    assert cost.raw_seconds == max(
        cost.flops / (DEFAULT_ROOFLINE["peak_flops"]
                      * DEFAULT_ROOFLINE["efficiency"]),
        cost.bytes / DEFAULT_ROOFLINE["hbm_bps"])
    assert DEFAULT_ROOFLINE == {"peak_flops": 989e12, "efficiency": 1.0,
                                "hbm_bps": 3.35e12}


def test_first_dispatch_of_a_program_is_not_observed():
    """A width's first prefill chunk is priced and its time not read; the
    decode is priced in a dead-lane run of its own, so even its first
    dispatch is measured against a warm program."""
    eng = _engine(_model())
    eng.add_request(np.arange(7) % 128, max_new_tokens=1)
    eng.run()
    assert set(eng.compile_reports) == {"prefill.b16"}
    assert eng._cost_scale is None
    eng.add_request(np.arange(9) % 128, max_new_tokens=1)
    eng.run()
    assert eng._cost_scale is not None


# -- the CLI ------------------------------------------------------------------

def test_cli_check_passes_on_the_cpu(capsys):
    from paddle_tpu_torch.tools import loadgen as cli
    try:
        rc = cli.main(["--device", "cpu", "--scenario", "chat",
                       "--duration", "0.5", "--check"])
    finally:
        _obs_off()
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "CHECK PASS" in err


def test_cli_mesh_flags_raise(capsys):
    """The mesh flags no longer raise: two in-process replicas behind the
    router serve the scenario and the report gains its mesh section
    (tests/test_torch_chaos_drill.py drives the rest of them)."""
    from paddle_tpu_torch.tools import loadgen as cli
    try:
        rc = cli.main(["--device", "cpu", "--scenario", "chat",
                       "--duration", "0.5", "--replicas", "2"])
    finally:
        _obs_off()
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert "# mesh: replicas=2 disaggregate=False" in captured.err
    assert '"mesh": {' in captured.out

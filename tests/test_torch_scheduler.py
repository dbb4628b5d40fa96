"""The port's SLO scheduler (inference/scheduler.py) and the engine's
preemption, brownout knobs and FIFO degradation against the JAX package's,
mirroring tests/test_scheduler.py.

scheduler.py is a copy of a jax-free module: its registries and decisions
equal the reference's on the same signals. The engines serve the same
requests in float32 with the reference's weights (convert.py): a greedy
stream preempted and resumed equals the reference engine's unpreempted
stream token for token; sampled streams are held to themselves through a
preempt/resume. TestSaturation drives the port's loadgen.run_scenario with
the ladder moved by the engine's cost model (its headroom) alone; torch
runs on one thread there, as in test_torch_loadgen.py.
"""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference import loadgen
from paddle_tpu_torch.inference.loadgen import (KNOWN_FINISH_REASONS,
                                                run_scenario)
from paddle_tpu_torch.inference.scheduler import (BROWNOUT_LEVELS, MAX_LEVEL,
                                                  PRIORITY_CLASSES,
                                                  SLOScheduler, _Signals,
                                                  level_index, level_name)
from paddle_tpu_torch.inference.serving import Request
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.resilience.faults import injected_faults

BAD = _Signals(headroom=-0.5)
GOOD = _Signals(headroom=0.9)

_PAIR = []
_REF = {}


def _pair():
    """(reference model, port model with the reference's weights), f32."""
    if not _PAIR:
        cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=256)
        paddle.seed(0)
        ref = JLlama(JConfig(**cfg))
        port = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _PAIR.extend((ref, port))
    return _PAIR


def _model():
    return _pair()[1]


def _engine(model, Engine=ContinuousBatchingEngine, **kw):
    kw.setdefault("num_blocks", 128)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", (16,))
    return Engine(model, **kw)


def _ref_stream(tag, prompt, **kw):
    """The reference engine's unpreempted stream, once per scenario."""
    if tag not in _REF:
        eng = _engine(_pair()[0], JEngine, max_batch=1)
        rid = eng.add_request(prompt, **kw)
        _REF[tag] = eng.run()[rid]
    return _REF[tag]


@pytest.fixture(autouse=True)
def _no_new_series():
    """Every test here leaves both packages' registries without the
    labelled series it created (an engine run creates them even while the
    layer is off), so the counter sets other files' tests compare do not
    depend on the order the files run in."""
    regs = (obs.get_registry(), jobs.get_registry())
    before = {id(m): set(m._children) for r in regs for m in r.collect()}
    yield
    for m in (m for r in regs for m in r.collect()):
        for key in set(m._children) - before.get(id(m), {()}):
            del m._children[key]


@pytest.fixture
def enabled_obs():
    obs.get_registry().reset()
    obs.enable()
    yield obs
    obs.disable()
    obs.get_registry().reset()


class TestRegistries:
    def test_priority_classes_closed_and_ordered(self):
        assert list(PRIORITY_CLASSES) == ["interactive", "batch",
                                          "best_effort"]
        assert PRIORITY_CLASSES == jsched.PRIORITY_CLASSES

    def test_brownout_levels_closed_and_ordered(self):
        assert list(BROWNOUT_LEVELS) == [
            "normal", "shrink_decode_steps", "reduce_draft_depth",
            "disable_speculation", "force_small_prefill_chunk",
            "cap_max_new_tokens", "shed_best_effort"]
        assert BROWNOUT_LEVELS == jsched.BROWNOUT_LEVELS
        assert MAX_LEVEL == len(BROWNOUT_LEVELS) - 1 == jsched.MAX_LEVEL

    def test_level_index_roundtrip(self):
        for i, name in enumerate(BROWNOUT_LEVELS):
            assert level_index(name) == i
            assert level_name(i) == name

    def test_unknown_level_raises(self):
        with pytest.raises(KeyError):
            level_index("panic")

    def test_unknown_priority_rejected_at_admission(self):
        eng = _engine(_model())
        with pytest.raises(ValueError):
            eng.add_request(np.arange(4), max_new_tokens=2,
                            priority="urgent")


class TestBrownoutLadder:
    """decide() alone: _Signals in, transitions out, against the
    reference's scheduler on the same signal sequences."""

    @pytest.mark.parametrize("seq", [
        "B" * 40, "B" * 12 + "G" * 40, "BGGGBGGGG" * 6, "BBGBBBGGGGGGGG" * 4])
    @pytest.mark.parametrize("knobs", [
        dict(escalate_after=2, recover_after=4, min_dwell=2),
        dict(escalate_after=1, recover_after=4, min_dwell=0)])
    def test_levels_follow_reference(self, seq, knobs):
        a, b = SLOScheduler(**knobs), jsched.SLOScheduler(**knobs)
        for c in seq:
            sig = BAD if c == "B" else GOOD
            jsig = jsched._Signals(headroom=sig.headroom)
            assert a.decide(sig) == b.decide(jsig)
            assert a.level == b.level
        assert (a.transitions_up, a.transitions_down) == (
            b.transitions_up, b.transitions_down)

    def test_escalates_one_rung_at_a_time(self):
        sched = SLOScheduler(escalate_after=2, recover_after=4, min_dwell=2)
        levels = []
        for _ in range(40):
            sched.decide(BAD)
            levels.append(sched.level)
        assert levels[-1] == MAX_LEVEL
        diffs = [b - a for a, b in zip(levels, levels[1:])]
        assert all(d in (0, 1) for d in diffs), diffs
        assert sum(diffs) == MAX_LEVEL
        assert len([d for d in diffs if d == 1]) < len(diffs) / 2

    def test_never_exceeds_max_level(self):
        sched = SLOScheduler(escalate_after=1, min_dwell=0)
        for _ in range(50):
            sched.decide(BAD)
        assert sched.level == MAX_LEVEL
        assert sched.transitions_up == MAX_LEVEL

    def test_recovery_is_slower_than_escalation(self):
        sched = SLOScheduler(escalate_after=1, recover_after=4, min_dwell=0)
        while sched.level < MAX_LEVEL:
            sched.decide(BAD)
        up_decisions = sched.transitions_up
        n = 0
        while sched.level > 0:
            sched.decide(GOOD)
            n += 1
            assert n < 200
        assert sched.transitions_down == MAX_LEVEL
        assert n >= 4 * MAX_LEVEL > up_decisions

    def test_one_bad_step_resets_recovery_streak(self):
        sched = SLOScheduler(escalate_after=1, recover_after=4, min_dwell=0)
        sched.decide(BAD)
        assert sched.level == 1
        for _ in range(3):
            assert not sched.decide(GOOD)
        sched.decide(BAD)
        assert sched.level == 2
        for _ in range(3):
            assert not sched.decide(GOOD)
        assert sched.level == 2
        assert sched.decide(GOOD)
        assert sched.level == 1

    def test_ttft_and_tpot_breaches_count_as_bad(self):
        sched = SLOScheduler(ttft_target=0.1, tpot_target=0.01,
                             escalate_after=1, min_dwell=0)
        sched.decide(_Signals(headroom=0.9, ttft_p95=0.5))
        assert sched.level == 1
        sched2 = SLOScheduler(ttft_target=0.1, tpot_target=0.01,
                              escalate_after=1, min_dwell=0)
        sched2.decide(_Signals(headroom=0.9, tpot_p99=0.5))
        assert sched2.level == 1

    def test_no_signals_is_not_bad(self):
        sched = SLOScheduler(escalate_after=1, min_dwell=0)
        for _ in range(5):
            assert not sched.decide(_Signals())
        assert sched.level == 0
        assert (SLOScheduler().ttft_target, SLOScheduler().tpot_target) == (
            jsched.SLOScheduler().ttft_target,
            jsched.SLOScheduler().tpot_target)


class TestBrownoutKnobs:
    def test_ladder_knobs_cumulative_and_reversible(self):
        """Each rung's knobs on the port's engine equal the reference
        engine's at the same rung."""
        ref, port = _pair()
        kw = dict(decode_steps=4, speculative_decode=True, draft_depth=2)
        eng = _engine(port, **kw)
        jeng = _engine(ref, JEngine, **kw)
        sched, jsch = SLOScheduler(mnt_cap=16), jsched.SLOScheduler(mnt_cap=16)
        base = (eng.decode_steps, eng.draft_depth, eng.spec, eng.chunk,
                eng._mnt_cap)
        assert base == (4, 2, True, eng._base_chunk, None)
        for name in list(BROWNOUT_LEVELS) + ["normal"]:
            for s, e in ((sched, eng), (jsch, jeng)):
                s.level = level_index(name)
                s._apply(e)
            got = (eng.decode_steps, eng.draft_depth, eng.spec,
                   sched.shed_best_effort, eng.chunk, eng._mnt_cap)
            want = (jeng.decode_steps, jeng.draft_depth, jeng.spec,
                    jsch.shed_best_effort, jeng.chunk, jeng._mnt_cap)
            assert got == want, name
        assert (eng.decode_steps, eng.draft_depth, eng.spec, eng.chunk,
                eng._mnt_cap) == base

    def test_recovery_respects_permanent_spec_degradation(self):
        eng = _engine(_model(), decode_steps=4, speculative_decode=True,
                      draft_depth=2)
        sched = SLOScheduler()
        sched.level = MAX_LEVEL
        sched._apply(eng)
        eng._disable_spec("drill")      # fault path: permanent
        sched.level = 0
        sched._apply(eng)
        assert eng.decode_steps == 4 and eng.draft_depth == 2
        assert not eng.spec             # stays off: fault wins over ladder

    def test_ladder_mid_run_keeps_the_stream(self):
        """Stepping the ladder mid-run (K halves, speculation goes off and
        on again) drains in-flight tiles under their own program: the
        stream equals the reference engine's unpreempted one."""
        p = (np.arange(9) * 7) % 128
        want = _ref_stream("ladder", p, max_new_tokens=20)
        eng = _engine(_model(), max_batch=1, decode_steps=4,
                      speculative_decode=True, draft_depth=2)
        sched = SLOScheduler()
        rid = eng.add_request(p, max_new_tokens=20)
        for i, lvl in enumerate((0, 0, 1, 3, 3, 2, 0)):
            sched.level = lvl
            sched._apply(eng)
            eng.step()
        out = eng.run()[rid]
        assert out == want
        assert {(False, 4, 2), (False, 2, 0)} <= eng.program_keys_used


class TestPreemptResume:
    def _drive_to_decode(self, eng):
        for _ in range(50):
            if eng._decode_active():
                return eng._decode_active()[0]
            eng.step()
        raise AssertionError("request never reached a decode lane")

    @pytest.mark.parametrize("spec", [False, True])
    def test_greedy_stream_byte_identical(self, spec):
        p = (np.arange(6) * 5) % 128
        ref = _ref_stream("greedy", p, max_new_tokens=10)
        assert len(ref) == 10
        eng = _engine(_model(), max_batch=1, speculative_decode=spec)
        rid = eng.add_request(p, max_new_tokens=10, priority="batch")
        lane = self._drive_to_decode(eng)
        eng.step()
        eng.step()
        assert eng._try_preempt(lane, why="test")
        assert eng._preempted          # parked, KV resident
        assert eng.pool.tables         # blocks NOT released
        out = eng.run()[rid]
        assert out == ref
        assert eng._preempted == {} and eng.pool.tables == {}

    def test_sampled_stream_byte_identical(self):
        p = (np.arange(8) * 3) % 128
        kw = dict(max_new_tokens=12, do_sample=True, temperature=0.8,
                  top_p=0.9, seed=7)
        base = _engine(_model(), max_batch=1)
        rid = base.add_request(p, **kw)
        ref = base.run()[rid]
        eng = _engine(_model(), max_batch=1)
        rid = eng.add_request(p, priority="batch", **kw)
        lane = self._drive_to_decode(eng)
        eng.step()
        assert eng._try_preempt(lane, why="test")
        out = eng.run()[rid]
        assert out == ref              # the draw keys on absolute position

    def test_parked_deadline_expires_with_timeout(self):
        eng = _engine(_model(), max_batch=1)
        p = (np.arange(6) * 5) % 128
        rid = eng.add_request(p, max_new_tokens=64, priority="batch",
                              deadline_s=30.0)
        lane = self._drive_to_decode(eng)
        eng.step()
        assert eng._try_preempt(lane, why="test")
        req, _len, _tok = eng._preempted[rid]
        req.t_deadline = time.perf_counter() - 1.0
        eng.run()
        req = eng.finished[rid]
        assert req.finish_reason == "timeout"
        assert eng._preempted == {} and eng.pool.tables == {}

    def test_preempt_refuses_empty_and_prefilling_lanes(self):
        eng = _engine(_model(), max_batch=2)
        assert not eng._try_preempt(0, why="test")      # empty lane
        eng.add_request((np.arange(20) * 7) % 128, max_new_tokens=4)
        eng.step()                                      # mid-prefill
        busy = [i for i, r in enumerate(eng.lanes) if r is not None]
        if busy and busy[0] in eng._prefill_tasks:
            assert not eng._try_preempt(busy[0], why="test")
        eng.run()

    def test_preempt_fault_keeps_the_lane(self):
        eng = _engine(_model(), max_batch=1)
        rid = eng.add_request((np.arange(6) * 5) % 128, max_new_tokens=8)
        lane = self._drive_to_decode(eng)
        with injected_faults("serve.preempt:1:TimeoutError"):
            assert not eng._try_preempt(lane, why="test")
        assert eng.lanes[lane] is not None and not eng._preempted
        assert len(eng.run()[rid]) == 8

    def test_cancel_withdraws_a_parked_request(self):
        eng = _engine(_model(), max_batch=1)
        rid = eng.add_request((np.arange(6) * 5) % 128, max_new_tokens=8)
        lane = self._drive_to_decode(eng)
        assert eng._try_preempt(lane, why="test")
        assert eng.cancel(rid) and not eng.cancel(rid)
        assert eng._preempted == {} and eng.pool.tables == {}
        assert rid not in eng.finished


class TestDRRFairness:
    def _order(self, eng, key):
        order = []
        while eng.queue:
            idx = eng.scheduler.pick_index(eng)
            order.append(getattr(eng.queue[idx], key))
            del eng.queue[idx]
        return order

    def test_flood_cannot_starve_short_tenant(self):
        orders = []
        for Engine, model, Sched in (
                (ContinuousBatchingEngine, _pair()[1], SLOScheduler),
                (JEngine, _pair()[0], jsched.SLOScheduler)):
            eng = _engine(model, Engine, scheduler=Sched(quantum=8))
            p = np.arange(6) % 128
            for _ in range(4):
                eng.add_request(p, max_new_tokens=50, tenant="A",
                                priority="batch")
            for _ in range(2):
                eng.add_request(p, max_new_tokens=4, tenant="B",
                                priority="batch")
            orders.append(self._order(eng, "tenant"))
        assert orders[0] == orders[1] == ["B", "B", "A", "A", "A", "A"]

    def test_priority_classes_strictly_dominate(self):
        eng = _engine(_model(), scheduler=SLOScheduler())
        p = np.arange(4) % 128
        eng.add_request(p, max_new_tokens=4, priority="best_effort")
        eng.add_request(p, max_new_tokens=4, priority="batch")
        eng.add_request(p, max_new_tokens=4, priority="interactive")
        assert self._order(eng, "priority") == [
            "interactive", "batch", "best_effort"]

    def test_tenant_quota_defers_and_counts(self, enabled_obs):
        eng = _engine(_model(), scheduler=SLOScheduler(tenant_quota=1))
        eng.lanes[0] = Request(99, np.arange(4), 4, None, tenant="A")
        eng.add_request(np.arange(4) % 128, max_new_tokens=4, tenant="A")
        eng.add_request(np.arange(4) % 128, max_new_tokens=4, tenant="B")
        idx = eng.scheduler.pick_index(eng)
        assert eng.queue[idx].tenant == "B"
        fam = obs.get_registry().get("serving_quota_deferrals_total")
        assert fam.labels(tenant="A").value == 1.0
        eng.lanes[0] = None

    def test_quota_counts_parked_lanes(self):
        eng = _engine(_model(), scheduler=SLOScheduler(tenant_quota=1))
        parked = Request(98, np.arange(4), 4, None, tenant="A")
        eng._preempted[98] = (parked, 4, 0)
        eng.add_request(np.arange(4) % 128, max_new_tokens=4, tenant="A")
        eng.add_request(np.arange(4) % 128, max_new_tokens=4, tenant="B")
        idx = eng.scheduler.pick_index(eng)
        assert eng.queue[idx].tenant == "B"
        eng._preempted.clear()

    def test_interactive_arrival_preempts_batch_lane(self):
        """Under pressure (an engaged ladder) a queued interactive request
        takes a batch lane; the parked batch stream resumes and ends as
        the reference engine's unpreempted one."""
        p = (np.arange(6) * 5) % 128
        want = _ref_stream("greedy16", p, max_new_tokens=16)
        sched = SLOScheduler(ttft_target=1e9, tpot_target=1e9)
        eng = _engine(_model(), max_batch=1, scheduler=sched)
        rid = eng.add_request(p, max_new_tokens=16, priority="batch")
        TestPreemptResume()._drive_to_decode(eng)
        eng.step()
        sched.level = 1
        rid2 = eng.add_request(np.arange(5) % 128, max_new_tokens=3)
        eng.step()
        assert sched.preempt_requests == 1 and rid in eng._preempted
        out = eng.run()
        assert out[rid] == want and len(out[rid2]) == 3


class TestFifoDegrade:
    def test_decision_fault_degrades_to_fifo(self, enabled_obs):
        eng = _engine(_model(), scheduler=True)
        p = (np.arange(6) * 5) % 128
        rid = eng.add_request(p, max_new_tokens=6, priority="batch")
        with injected_faults("serve.sched_decide:1:RuntimeError"):
            out = eng.run()
        assert eng.scheduler.fifo
        assert eng.finished[rid].finish_reason in KNOWN_FINISH_REASONS
        assert len(out[rid]) == 6
        assert eng.decode_steps == eng._base_decode_steps
        assert eng.scheduler.level == 0
        assert not eng.scheduler.shed_best_effort
        fam = obs.get_registry().get("serving_runtime_degradations_total")
        assert fam.labels(what="sched_fifo").value == 1.0
        eng.add_request(p, max_new_tokens=2, priority="best_effort")
        eng.add_request(p, max_new_tokens=2, priority="interactive")
        assert eng.scheduler.pick_index(eng) == 0
        assert eng.scheduler.should_resume(eng)
        eng.run()

    def test_scheduler_true_builds_default(self):
        eng = _engine(_model(), scheduler=True)
        assert isinstance(eng.scheduler, SLOScheduler)
        assert not eng.scheduler.fifo


class TestShedBestEffort:
    def test_deepest_rung_sheds_best_effort_at_admission(self, enabled_obs):
        sched = SLOScheduler()
        eng = _engine(_model(), scheduler=sched)
        sched.level = MAX_LEVEL
        sched._apply(eng)
        p = np.arange(4) % 128
        rid_be = eng.add_request(p, max_new_tokens=4,
                                 priority="best_effort")
        rid_ia = eng.add_request(p, max_new_tokens=40,
                                 priority="interactive")
        out = eng.run()
        assert eng.finished[rid_be].finish_reason == "shed"
        assert out[rid_be] == []
        assert eng.finished[rid_ia].finish_reason in ("eos", "length")
        # the cap_max_new_tokens rung reshaped the interactive budget
        assert len(out[rid_ia]) == sched.mnt_cap
        assert torch.is_tensor(eng._dev["toks"])


class TestSaturation:
    def test_scheduler_engages_and_recovers_under_ramp(self, enabled_obs):
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            self._ramp()
        finally:
            torch.set_num_threads(n_threads)

    def _ramp(self):
        model = _model()
        # saturable: one decode step per dispatch, 2 lanes. Targets are
        # effectively disabled so engagement and recovery are driven by
        # the headroom signal (and priority preemption) alone
        eng = _engine(model, max_batch=2, decode_steps=1, max_queue=32,
                      prefill_buckets=(16, 32),
                      scheduler=SLOScheduler(ttft_target=1e9,
                                             tpot_target=1e9,
                                             escalate_after=1,
                                             min_dwell=0))
        eng.add_request(np.arange(7) % 128, max_new_tokens=4)
        eng.add_request(np.arange(20) % 128, max_new_tokens=4)
        eng.run()       # price and calibrate the cost model
        assert eng.predicted_service_seconds(output_tokens=8) is not None

        # structured_output's ramp, to 96 rps where the reference's ends at
        # 24: the reference's engine on the CPU saturates at 24, the
        # port's serves that without saturating on some runs, and the
        # test's premise is a ramp into saturation
        ramp = loadgen.SCENARIOS["structured_output"]
        ramp = loadgen.Scenario(ramp.name, **{
            s: getattr(ramp, s) for s in loadgen.Scenario.__slots__
            if s not in ("name", "rate_end_rps")}, rate_end_rps=96.0)
        rep = run_scenario(eng, ramp, seed=3, duration_s=1.5,
                           sample_every_s=0.1)
        sched = eng.scheduler
        assert not sched.fifo
        # the loop actually acted under saturation
        assert sched.transitions_up + sched.preempt_requests > 0
        # interactive TTFT p95 held within the DEFAULT_SLOS objective
        # while batch took the pressure
        cls = rep["classes"].get("interactive")
        assert cls and cls["finished"] > 0
        assert cls["ttft_p95"] <= 2.5
        # reversal: once arrivals stop, consecutive good decisions walk
        # the ladder back to 0
        deadline = time.time() + 30.0
        while sched.level > 0 and time.time() < deadline:
            eng.step()
            time.sleep(0.01)
        assert sched.level == 0
        assert eng.decode_steps == eng._base_decode_steps
        fam = obs.get_registry().get("serving_brownout_level")
        assert fam.value == 0.0
        # no request lost, every finish reason known
        assert set(rep["finished"]) <= set(KNOWN_FINISH_REASONS)
        assert not eng.has_work()
        assert eng._preempted == {} and eng.pool.tables == {}

"""The port's multi-adapter (LoRA) serving — inference/adapters.py and the
engine and scheduler wiring — against the JAX package's, mirroring
tests/test_adapters.py.

The engines serve the same requests in float32 with the reference's model
weights (convert.py) and the reference's adapter factors copied into the
port's store: greedy streams on base and adapter lanes must equal the
reference engine's token for token. A hot swap fills a slot of the
store's pools in place and adds no program. TestLoadgenScenario and
TestAdapterSweeps drive the port's loadgen; the mesh cases
(TestMeshAdapters, TestAdapterSweeps' replica kill) wait for the port of
the serving mesh (ROADMAP.md slice 4, step 6).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import adapters as jadapters
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import generation
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.adapters import (
    AdapterLoadError, AdapterStore, demo_store_for_engine, make_demo_store,
    per_adapter_slos)
from paddle_tpu_torch.inference.scheduler import SLOScheduler
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.resilience import faults
from torch_one_thread import one_torch_thread  # noqa: F401

_PAIR = []
_REF = {}


def _pair():
    """(reference model, port model with the reference's weights), f32."""
    if not _PAIR:
        cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=4, max_position_embeddings=256)
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
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", (16,))
    return Engine(model, **kw)


def _store(model=None, names=("lora0", "lora1"), **kw):
    """The port's store holding the reference demo store's factors."""
    jstore = jadapters.make_demo_store(_pair()[0], list(names), **kw)
    store = AdapterStore.for_model(model or _model(),
                                   rank=jstore.rank, n_slots=jstore.n_slots)
    for name in names:
        w = jstore._registry[name]
        store.register(name, w.a_q, w.b_q, w.a_v, w.b_v)
    return store


def _ref_streams(tag, requests, **kw):
    """The reference engine's streams for [(prompt, n, adapter)], once per
    scenario."""
    if tag not in _REF:
        ref = _pair()[0]
        eng = _engine(ref, JEngine, adapters=jadapters.make_demo_store(
            ref, ["lora0", "lora1"]), **kw)
        rids = [eng.add_request(p, max_new_tokens=n, adapter=a)
                for p, n, a in requests]
        out = eng.run()
        _REF[tag] = [out[r] for r in rids]
    return _REF[tag]


def _dense(prompt, n):
    out = generation.generate(_model(), torch.as_tensor(prompt)[None],
                              max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def _prompt(n=6, seed=7):
    return np.random.RandomState(seed).randint(1, 128, (n,))


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


def _counter(name, **labels):
    fam = obs.get_registry().get(name)
    if fam is None:
        return 0.0
    if labels:
        try:
            return fam.labels(**labels).value
        except KeyError:
            return 0.0
    return fam.value


class TestStoreRegistry:
    def test_slot_pool_needs_base_slot(self):
        with pytest.raises(ValueError, match="n_slots"):
            AdapterStore(2, 64, 64, 64, rank=4, n_slots=1, device="cpu")

    def test_reserved_and_empty_names_rejected(self):
        store = AdapterStore.for_model(_model(), n_slots=2)
        for bad in ("base", ""):
            with pytest.raises(ValueError, match="name"):
                store.register(bad, *[np.zeros(1)] * 4)

    def test_register_shape_checked(self):
        store = AdapterStore.for_model(_model(), rank=4, n_slots=2)
        L, H, r = store.num_layers, store.hidden, store.rank
        good = dict(a_q=np.zeros((L, H, r), np.float32),
                    b_q=np.zeros((L, r, store.q_out), np.float32),
                    a_v=np.zeros((L, H, r), np.float32),
                    b_v=np.zeros((L, r, store.v_out), np.float32))
        for attr in good:
            bad = dict(good)
            bad[attr] = (np.zeros((L, 3, r), np.float32)
                         if attr.startswith("a_")
                         else np.zeros((L, r, 3), np.float32))
            with pytest.raises(ValueError, match=attr):
                store.register("x", **bad)
        store.register("x", **good)
        assert store.can_serve("x") and not store.can_serve("y")

    def test_registry_capacity_bounded(self):
        store = AdapterStore.for_model(_model(), max_adapters=1)
        L, H, r = store.num_layers, store.hidden, store.rank
        args = (np.zeros((L, H, r), np.float32),
                np.zeros((L, r, store.q_out), np.float32),
                np.zeros((L, H, r), np.float32),
                np.zeros((L, r, store.v_out), np.float32))
        store.register("a", *args)
        with pytest.raises(AdapterLoadError, match="registry full"):
            store.register("b", *args)

    def test_unknown_acquire_is_typed(self):
        with pytest.raises(AdapterLoadError, match="unknown adapter"):
            _store().acquire("nope")

    def test_demo_store_is_the_reference_demo_store(self):
        """make_demo_store draws the reference's bits (numpy, one seed)
        and lives on the model's device."""
        jstore = jadapters.make_demo_store(_pair()[0], ["a", "b"], rank=8)
        store = make_demo_store(_model(), ["a", "b"], rank=8)
        assert store.A_q.device.type == "cpu"
        assert store.program_key == jstore.program_key
        for name in ("a", "b"):
            for attr in ("a_q", "b_q", "a_v", "b_v"):
                np.testing.assert_array_equal(
                    getattr(store._registry[name], attr),
                    getattr(jstore._registry[name], attr))


class TestStoreResidency:
    def test_acquire_refcounts_and_reuses_slot(self, enabled_obs):
        store = _store(names=("a", "b"), n_slots=3)
        s1 = store.acquire("a")
        assert s1 != 0 and store.refcount(s1) == 1
        assert store.acquire("a") == s1
        assert store.refcount(s1) == 2
        assert store.stats()["loads"] == 1
        store.release(s1)
        store.release(s1)
        assert store.refcount(s1) == 0
        assert store.resident() == {"a": s1}

    def test_lru_evicts_oldest_idle_slot(self, enabled_obs):
        store = _store(names=("a", "b", "c"), n_slots=3)
        sa, sb = store.acquire("a"), store.acquire("b")
        store.release(sa)
        store.release(sb)
        sc = store.acquire("c")
        assert sc == sa
        assert sorted(store.resident()) == ["b", "c"]
        assert store.stats()["evictions"] == 1
        assert _counter("serving_adapter_evictions_total", adapter="a") == 1

    def test_pinned_slots_never_evicted(self):
        store = _store(names=("a", "b", "c"), n_slots=3)
        store.acquire("a")
        store.acquire("b")
        with pytest.raises(AdapterLoadError, match="pinned"):
            store.acquire("c")
        assert sorted(store.resident()) == ["a", "b"]

    def test_check_resident_guards_stale_slots(self):
        store = _store(names=("a", "b", "c"), n_slots=3)
        store.check_resident(0)
        sa = store.acquire("a")
        store.check_resident(sa)
        store.release(sa)
        with pytest.raises(AdapterLoadError, match="not resident"):
            store.check_resident(sa)

    def test_program_key_is_shape_only(self):
        store = _store(names=("a", "b", "c"), n_slots=3)
        key = store.program_key
        sa = store.acquire("a")
        store.release(sa)
        store.acquire("b")
        store.acquire("c")
        assert store.program_key == key

    def test_upload_fills_the_pools_in_place(self):
        """A load writes its slot inside the same pool tensors (the
        captured decode graphs hold their addresses); slot 0 stays 0."""
        store = _store(names=("a", "b", "c"), n_slots=3)
        pools = (store.A_q, store.B_q, store.A_v, store.B_v)
        ptrs = [p.data_ptr() for p in pools]
        sa = store.acquire("a")
        store.release(sa)
        store.acquire("b")
        sc = store.acquire("c")                 # evicts a, reuses its slot
        assert sc == sa
        assert [p.data_ptr() for p in (store.A_q, store.B_q, store.A_v,
                                       store.B_v)] == ptrs
        np.testing.assert_array_equal(store.B_v[:, sc].numpy(),
                                      store._registry["c"].b_v)
        assert not any(p[:, 0].any() for p in pools)

    def test_demo_store_for_engine_matches_model_store(self):
        eng = _engine(_model())
        via_model = make_demo_store(_model(), ["a"])
        via_engine = demo_store_for_engine(eng, ["a"], n_slots=8)
        wa, wb = via_model._registry["a"], via_engine._registry["a"]
        for attr in ("a_q", "b_q", "a_v", "b_v"):
            np.testing.assert_array_equal(getattr(wa, attr),
                                          getattr(wb, attr))
        assert via_engine.device == eng.device

    def test_mismatched_store_is_a_value_error(self):
        store = AdapterStore(3, 64, 64, 64, rank=4, device="cpu")
        with pytest.raises(ValueError, match="dimensions"):
            _engine(_model(), adapters=store)


class TestEngineIdentity:
    def test_base_streams_identical_with_store_attached(self):
        prompts = [_prompt(6, 1), _prompt(9, 2), _prompt(5, 3)]
        want = _ref_streams("base", [(p, 8, None) for p in prompts])
        plain = _engine(_model())
        rids = [plain.add_request(p, max_new_tokens=8) for p in prompts]
        out = plain.run()
        assert [out[r] for r in rids] == want
        stored = _engine(_model(), adapters=_store())
        rids = [stored.add_request(p, max_new_tokens=8) for p in prompts]
        got = stored.run()
        assert [got[r] for r in rids] == want

    @pytest.mark.parametrize("spec", [False, True])
    def test_adapter_stream_matches_reference(self, spec):
        """Base and adapter lanes in one engine equal the reference
        engine's streams; the delta really lands."""
        p = _prompt(8)
        reqs = [(p, 10, None), (p, 10, "lora0"), (_prompt(7, 4), 10,
                                                   "lora1")]
        want = _ref_streams("mixed", reqs)
        eng = _engine(_model(), adapters=_store(), max_batch=3,
                      speculative_decode=spec, decode_steps=3)
        rids = [eng.add_request(q, max_new_tokens=n, adapter=a)
                for q, n, a in reqs]
        out = eng.run()
        assert [out[r] for r in rids] == want
        assert want[0] == _dense(p, 10) and want[1] != want[0]

    def test_finish_releases_slots_and_pool(self):
        store = _store()
        eng = _engine(_model(), adapters=store)
        eng.add_request(_prompt(6, 1), max_new_tokens=6, adapter="lora0")
        eng.add_request(_prompt(7, 2), max_new_tokens=6, adapter="lora1")
        eng.run()
        assert all(v == 0 for v in store._refs.values())
        assert eng.pool.tables == {}
        assert sorted(store.resident()) == ["lora0", "lora1"]

    def test_hot_swap_never_adds_a_program(self, enabled_obs):
        """8 adapters through 3 slots: every pass churns slots, no program
        is added (jit_retrace_total counts captures on the card) and the
        decode program keys stay the same."""
        names = ["lora%d" % i for i in range(8)]
        eng = _engine(_model(), adapters=_store(names=names, n_slots=4))
        eng.add_request(_prompt(6), max_new_tokens=4)
        eng.run()
        r0 = _counter("jit_retrace_total")
        keys = set(eng.program_keys_used)
        for nm in names:
            eng.add_request(_prompt(6), max_new_tokens=4, adapter=nm)
            eng.run()
        assert _counter("jit_retrace_total") == r0
        assert eng.program_keys_used == keys
        assert eng.adapters.stats()["evictions"] >= 5


class TestTypedRejection:
    def test_unknown_adapter_rejected_base_lane_unharmed(self, enabled_obs):
        p = _prompt(7)
        eng = _engine(_model(), adapters=_store())
        r_bad = eng.add_request(_prompt(6, 9), max_new_tokens=8,
                                adapter="ghost")
        r_ok = eng.add_request(p, max_new_tokens=8)
        out = eng.run()
        assert eng.finished[r_bad].finish_reason == "rejected"
        assert out[r_bad] == []
        assert out[r_ok] == _dense(p, 8)
        assert _counter("serving_rejected_total", reason="adapter") == 1
        assert _counter("serving_adapter_load_failures_total") == 1

    def test_no_store_at_all_rejects_adapter_requests(self):
        eng = _engine(_model())
        rid = eng.add_request(_prompt(6), max_new_tokens=6, adapter="x")
        assert eng.run()[rid] == []
        assert eng.finished[rid].finish_reason == "rejected"

    @pytest.mark.chaos
    @pytest.mark.parametrize("site", ["serve.adapter_load",
                                      "serve.adapter_gather"])
    def test_injected_fault_rejects_then_recovers(self, enabled_obs, site):
        p = _prompt(8)
        store = _store()
        eng = _engine(_model(), adapters=store)
        with faults.injected_faults(f"{site}:1:TimeoutError"):
            r1 = eng.add_request(p, max_new_tokens=8, adapter="lora0")
            out = eng.run()
            assert faults.injected_counts().get(site) == 1
        assert eng.finished[r1].finish_reason == "rejected"
        assert out[r1] == []
        assert all(v == 0 for v in store._refs.values())
        assert eng.pool.tables == {}
        r2 = eng.add_request(p, max_new_tokens=8, adapter="lora0")
        assert eng.run()[r2] == _ref_streams("lora0", [(p, 8, "lora0")])[0]


class TestSchedulerQuota:
    def test_adapter_quota_defers_counted(self, enabled_obs):
        eng = _engine(_model(), adapters=_store(),
                      scheduler=SLOScheduler(adapter_quota=1))
        rids = [eng.add_request(_prompt(6, s), max_new_tokens=8,
                                adapter="lora0") for s in (1, 2, 3)]
        out = eng.run()
        assert all(len(out[r]) == 8 for r in rids)
        assert _counter("serving_adapter_quota_deferrals_total",
                        adapter="lora0") >= 1

    def test_base_requests_exempt_from_adapter_quota(self, enabled_obs):
        eng = _engine(_model(), adapters=_store(),
                      scheduler=SLOScheduler(adapter_quota=1))
        rids = [eng.add_request(_prompt(6, s), max_new_tokens=6)
                for s in (1, 2)]
        out = eng.run()
        assert all(len(out[r]) == 6 for r in rids)
        assert _counter("serving_adapter_quota_deferrals_total",
                        adapter="lora0") == 0

    def test_preempted_adapter_lane_resumes_exactly(self):
        """A parked adapter lane keeps its slot and resumes on it."""
        p = _prompt(8)
        store = _store()
        eng = _engine(_model(), adapters=store, max_batch=1)
        rid = eng.add_request(p, max_new_tokens=10, adapter="lora0",
                              priority="batch")
        while not eng._decode_active():
            eng.step()
        eng.step()
        slot = eng.lanes[0].adapter_id
        assert eng._try_preempt(0, why="test")
        assert store.refcount(slot) == 1        # held while parked
        assert eng.run()[rid] == _ref_streams(
            "lora0_10", [(p, 10, "lora0")])[0]
        assert store.refcount(slot) == 0


class TestPerAdapterSLO:
    def test_specs_evaluate_per_label(self, enabled_obs):
        from paddle_tpu_torch.observability.slo import SLOEngine
        eng = _engine(_model(), adapters=_store())
        eng.add_request(_prompt(6, 1), max_new_tokens=6, adapter="lora0")
        eng.add_request(_prompt(7, 2), max_new_tokens=6)
        eng.run()
        specs = per_adapter_slos(["lora0"], ttft_objective=60.0,
                                 tpot_objective=30.0)
        assert [s.name for s in specs] == [
            s.name for s in jadapters.per_adapter_slos(["lora0"])]
        slo_eng = SLOEngine(specs=specs)
        slo_eng.observe(obs.snapshot(), t=0.0)
        verdict = slo_eng.evaluate(emit=False)
        names = {s["name"] for s in verdict["slos"]}
        assert "adapter_lora0_ttft_p95" in names
        assert verdict["ok"]
        assert all(s["count"] >= 1 for s in verdict["slos"])
        fam = obs.get_registry().get("serving_adapter_ttft_seconds")
        assert {"lora0", "base"} <= {lbl[0][1] for lbl in fam._children}


class TestLoadgenScenario:
    def test_multi_adapter_scenario_registered(self):
        from paddle_tpu_torch.inference.loadgen import SCENARIOS
        sc = SCENARIOS["multi_adapter"]
        assert sc.adapter_population > 0
        assert sc.adapter_zipf > 1.0

    def test_short_run_produces_adapter_evidence(self, enabled_obs):
        """loadgen installs the demo store on a cold store-less engine,
        warms every program before its window and reports the run's
        adapter loads; nothing recompiles inside the window."""
        from paddle_tpu_torch.inference.loadgen import (
            Scenario, check_report, run_scenario)
        sc = Scenario("mini_adapters", arrival="poisson", rate_rps=30.0,
                      duration_s=0.4, prompt_len=(4, 10),
                      output_tokens=(3, 6), adapter_population=3,
                      deadline_s=15.0)
        eng = _engine(_model(), max_batch=4, num_blocks=128)
        report = run_scenario(eng, sc, seed=5)
        ad = report["adapters"]
        assert ad is not None
        assert ad["population"] == 3
        assert ad["loads"] >= 1
        assert ad["load_failures"] == 0
        assert ad["swap_recompiles"] == 0
        assert ad["per_adapter"]        # per-adapter quantiles present
        assert not [p for p in check_report(report, min_adapter_loads=1)
                    if "adapter" in p]

    def test_warm_engine_without_a_store_is_refused(self):
        """An engine that already ran a program cannot take the store
        loadgen would install (its programs were built without adapter
        slots)."""
        from paddle_tpu_torch.inference.loadgen import run_scenario
        eng = _engine(_model())
        eng.add_request(_prompt(6), max_new_tokens=2)
        eng.run()
        with pytest.raises(ValueError, match="already warm"):
            run_scenario(eng, "multi_adapter", seed=0, duration_s=0.1)


class TestAdapterSweeps:
    def test_saturation_sweep_small_pool_many_adapters(self, enabled_obs):
        # 12 adapters through a 4-slot pool under a saturating open
        # mix: every request finishes with a valid reason, refcounts
        # drain, and the whole sweep never recompiles
        from paddle_tpu_torch.inference.loadgen import KNOWN_FINISH_REASONS
        names = ["lora%d" % i for i in range(12)]
        store = _store(names=names, n_slots=4)
        eng = _engine(_model(), adapters=store, max_batch=4, num_blocks=128)
        eng.add_request(_prompt(6), max_new_tokens=4)
        eng.run()                               # compile outside the gate
        r0 = _counter("jit_retrace_total")
        rs = np.random.RandomState(22)
        rids = []
        for i in range(36):
            rids.append(eng.add_request(
                rs.randint(1, 128, (int(rs.randint(4, 12)),)),
                max_new_tokens=int(rs.randint(3, 8)),
                adapter=names[int(rs.randint(0, 12))]))
            if i % 6 == 5:
                eng.step()
        eng.run()
        for rid in rids:
            assert eng.finished[rid].finish_reason in KNOWN_FINISH_REASONS
        assert all(v == 0 for v in store._refs.values())
        assert eng.pool.tables == {}
        assert _counter("jit_retrace_total") == r0
        assert store.stats()["evictions"] >= 8  # the pool really churned


def test_store_attaches_before_the_first_capture_only():
    """loadgen attaches a store to a cold engine; once a decode program
    is captured (built without adapter slots) attaching one raises."""
    eng = _engine(_model())
    assert "adapter_ids" not in eng._dev
    eng.adapters = _store()
    assert "adapter_ids" in eng._dev
    eng.adapters = None
    assert "adapter_ids" not in eng._dev
    eng._graphs[(False, 4, 0)] = object()      # a captured program
    with pytest.raises(ValueError, match="before the first decode"):
        eng.adapters = _store()

"""The port's speculative decode and quantized KV blocks against the JAX
package's, mirroring tests/test_spec_decode.py.

Both engines serve the same requests in float32 with the reference's
weights carried across (convert.py). Greedy streams must be equal token for
token: the port's speculative streams, at every tiling and draft depth and
on every drafter, against the reference engine's. The port verifies each
drafted position with the plain decode step's own operations, so its
speculative streams also equal its plain ones exactly. Sampled streams come
from the port's own counter-based draw and are held to themselves across
tilings, with speculation on and off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import drafting as jdrafting
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import generation
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine, drafting
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as pa

_PAIRS = {}
_REF = {}


def _pair(kv_heads=4, hidden=64):
    """(reference model, port model with the reference's weights), f32."""
    key = (kv_heads, hidden)
    if key not in _PAIRS:
        cfg = dict(vocab_size=128, hidden_size=hidden,
                   intermediate_size=2 * hidden, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=kv_heads,
                   max_position_embeddings=256)
        paddle.seed(0)
        ref = JLlama(JConfig(**cfg))
        port = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _PAIRS[key] = (ref, port)
    return _PAIRS[key]


def _run(Engine, model, prompts, n, sample=False, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_buckets", (16,))
    eng = Engine(model, **kw)
    skw = (dict(do_sample=True, temperature=0.8, top_k=20, seed=11)
           if sample else {})
    rids = [eng.add_request(p, max_new_tokens=n, **skw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _ref_run(tag, prompts, n, kv_heads=4, **kw):
    """The reference engine's greedy streams, once per scenario."""
    if tag not in _REF:
        _REF[tag] = _run(JEngine, _pair(kv_heads)[0], prompts, n, **kw)
    return _REF[tag]


def _dense(model, prompt, n):
    out = generation.generate(model, torch.as_tensor(prompt)[None],
                              max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def _greedy_prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 128, (7,)), rs.randint(0, 128, (13,))]


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


class TestSpecGreedyIdentity:
    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_spec_matches_reference_engine(self, depth):
        """The port's speculative greedy streams equal the reference
        engine's speculative and plain streams at depths 1-3."""
        prompts = _greedy_prompts()
        base = _ref_run("base", prompts, 18, decode_steps=3)
        want = _ref_run(("spec", depth), prompts, 18, decode_steps=3,
                        speculative_decode=True, draft_depth=depth)
        assert want == base
        port = _pair()[1]
        assert base == [_dense(port, p, 18) for p in prompts]
        got = _run(ContinuousBatchingEngine, port, prompts, 18,
                   decode_steps=3, speculative_decode=True,
                   draft_depth=depth)
        assert got == want

    def test_byte_identical_across_steps_and_depths(self):
        """ON vs OFF across decode_steps x draft_depth: committed greedy
        streams never change."""
        prompts = _greedy_prompts()
        want = _ref_run("base", prompts, 18, decode_steps=3)
        port = _pair()[1]
        for k in (1, 3, 8):
            base = _run(ContinuousBatchingEngine, port, prompts, 18,
                        decode_steps=k)
            assert base == want, f"non-spec K={k} diverged"
            for d in (1, 2, 4):
                spec = _run(ContinuousBatchingEngine, port, prompts, 18,
                            decode_steps=k, speculative_decode=True,
                            draft_depth=d)
                assert spec == base, f"spec K={k} D={d} changed the stream"

    @pytest.mark.parametrize("which", ["backoff", "suffix"])
    def test_pluggable_drafters_match_reference(self, which):
        """The drafter= hook with drafting.py's drafters: the port's
        streams equal the reference engine's on a repetitive prompt, where
        drafts get accepted."""
        rs = np.random.RandomState(12)
        prompts = [np.tile(rs.randint(1, 128, (5,)), 4)[:16],
                   rs.randint(1, 128, (9,))]
        make = {"backoff": lambda m: m.backoff_drafter((3, 2)),
                "suffix": lambda m: m.suffix_drafter()}[which]
        want = _ref_run(("drafter", which), prompts, 12, decode_steps=3,
                        speculative_decode=True, draft_depth=2,
                        drafter=make(jdrafting))
        got = _run(ContinuousBatchingEngine, _pair()[1], prompts, 12,
                   decode_steps=3, speculative_decode=True, draft_depth=2,
                   drafter=make(drafting))
        assert got == want

    def test_spec_metrics_move(self, enabled_obs):
        """A speculative run counts drafts and accepts and lands an
        acceptance-rate observation with a trace-id exemplar."""
        _run(ContinuousBatchingEngine, _pair()[1], [np.arange(9) % 128], 16,
             decode_steps=4, speculative_decode=True, draft_depth=2)
        drafted = enabled_obs.metric("serving_draft_tokens_total").value
        accepted = enabled_obs.metric("serving_accepted_tokens_total").value
        assert drafted > 0 and 0 <= accepted <= drafted
        hist = enabled_obs.get_registry().get("serving_spec_acceptance_rate")
        assert hist.count >= 1
        assert any(tid for _, tid, _ in hist.exemplars())

    def test_draft_verify_fault_turns_speculation_off(self):
        """The serve.draft_verify fault site degrades to the plain decode
        for good; the stream is unchanged."""
        from paddle_tpu_torch.resilience.faults import injected_faults
        prompts = _greedy_prompts()
        port = _pair()[1]
        eng = ContinuousBatchingEngine(
            port, num_blocks=64, block_size=8, max_batch=4,
            prefill_buckets=(16,), decode_steps=3, speculative_decode=True)
        rids = [eng.add_request(p, max_new_tokens=18) for p in prompts]
        with injected_faults("serve.draft_verify:3:TimeoutError"):
            out = eng.run()
        assert not eng.spec and not eng._spec_allowed
        assert [out[r] for r in rids] == _ref_run(
            "base", prompts, 18, decode_steps=3)


class TestDrafterFunctions:
    @pytest.mark.parametrize("name", ["ngram", "backoff", "suffix"])
    def test_drafts_equal_reference(self, name):
        """Each drafter on the same history buffer gives the reference's
        drafts: lanes with repeats, without, and at the start."""
        rs = np.random.RandomState(4)
        hmax, B, depth = 48, 5, 3
        hist = rs.randint(0, 6, (B, hmax))
        hist[1] = rs.randint(0, 128, hmax)      # almost no repeats
        lens = np.array([20, 30, 3, 47, 0])
        toks = hist[np.arange(B), lens]
        jfn, tfn = {
            "ngram": (lambda h, n, t, d: jserving._ngram_draft(h, n, t, d, 3),
                      lambda h, n, t, d: serving._ngram_draft(h, n, t, d, 3)),
            "backoff": (jdrafting.backoff_drafter((3, 2)),
                        drafting.backoff_drafter((3, 2))),
            "suffix": (jdrafting.suffix_drafter(3, 2),
                       drafting.suffix_drafter(3, 2)),
        }[name]
        want = np.asarray(jfn(jnp.asarray(hist, jnp.int32),
                              jnp.asarray(lens, jnp.int32),
                              jnp.asarray(toks, jnp.int32), depth))
        got = tfn(torch.as_tensor(hist), torch.as_tensor(lens),
                  torch.as_tensor(toks), depth)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)

    def test_scenario_tables_match_reference(self):
        assert drafting.SCENARIO_DRAFT_STATS == jdrafting.SCENARIO_DRAFT_STATS
        for sc in list(jdrafting.SCENARIO_DRAFT_STATS) + ["unknown"]:
            assert (drafting.scenario_draft_depth(sc)
                    == jdrafting.scenario_draft_depth(sc))
            assert (drafting.scenario_drafter(sc).label
                    == jdrafting.scenario_drafter(sc).label)
        with pytest.raises(ValueError):
            drafting.backoff_drafter(())
        with pytest.raises(ValueError):
            drafting.suffix_drafter(2, 3)


class TestSpecSampled:
    def test_sampled_reproducible_across_tilings(self):
        """Seeded sampled lanes: spec at any tiling == non-spec at any
        tiling."""
        port = _pair(kv_heads=2)[1]
        rs = np.random.RandomState(3)
        prompts = [rs.randint(0, 128, (7,)), rs.randint(0, 128, (11,))]
        base = _run(ContinuousBatchingEngine, port, prompts, 14, sample=True,
                    decode_steps=3)
        for k, d in ((1, 2), (8, 2), (4, 4)):
            spec = _run(ContinuousBatchingEngine, port, prompts, 14,
                        sample=True, decode_steps=k,
                        speculative_decode=True, draft_depth=d)
            assert spec == base, f"sampled spec K={k} D={d} diverged"


class TestRollbackExactness:
    @pytest.mark.parametrize("fmt_name", ["native", "int8", "fp8_e4m3"])
    def test_write_plus_rollback_equals_sequential(self, fmt_name):
        """Cache bytes after a C-token speculative write + rollback of the
        rejected tail equal sequential single-token writes of the kept
        prefix alone — for every kept-prefix length."""
        fmt = pa.KVBlockFormat(fmt_name, native_dtype=torch.float32)
        rs = np.random.RandomState(5)
        NB, BS, KVH, D, B, C = 6, 4, 2, 8, 2, 3
        scratch = NB - 1
        tables = torch.tensor([[0, 1, scratch], [2, 3, scratch]])
        start = torch.tensor([3, 5])               # crosses block edges
        active = torch.tensor([True, True])
        k0 = rs.randint(-3, 4, (NB, BS, KVH, D)).astype(np.float32)
        s0 = rs.rand(NB, BS, KVH).astype(np.float32)

        def pools():
            store = fmt.store_dtype
            kc = torch.tensor(k0).to(store)
            vc = torch.tensor(k0[::-1].copy()).to(store)
            if fmt.quantized:
                ks = torch.as_tensor(s0).to(fmt.scale_dtype)
                return kc, vc, ks, ks + 0.5
            return kc, vc, None, None

        k_new = torch.as_tensor(rs.randn(B, C, KVH, D).astype(np.float32))
        v_new = torch.as_tensor(rs.randn(B, C, KVH, D).astype(np.float32))
        f = fmt if fmt.quantized else None
        for m in range(C + 1):
            keep = (torch.arange(C)[None, :] < m) & active[:, None]
            kc, vc, ks, vs = pools()
            *_, saved = pa.kv_write_tokens(f, kc, vc, ks, vs, k_new, v_new,
                                           tables, start, active=active,
                                           scratch_block=scratch)
            pa.kv_rollback_tokens(f, kc, vc, ks, vs, saved, tables, start,
                                  keep, active=active, scratch_block=scratch)
            sk, sv, sks, svs = pools()
            for i in range(m):
                pa.kv_write_token(f, sk, sv, sks, svs, k_new[:, i],
                                  v_new[:, i], tables, start + i,
                                  active=active, scratch_block=scratch)
            live = torch.arange(NB) != scratch     # scratch holds garbage
            for a, b in ((kc, sk), (vc, sv)) + (
                    ((ks, sks), (vs, svs)) if fmt.quantized else ()):
                assert torch.equal(a[live].view(torch.uint8)
                                   if a.element_size() == 1 else a[live],
                                   b[live].view(torch.uint8)
                                   if b.element_size() == 1 else b[live]), m

    def test_verify_query_equals_decode_step_bit_for_bit(self):
        """paged_attention_verify's query i is paged_attention_decode_inner
        at seq_lens base + i + 1, bit for bit, in bf16: why speculation
        cannot change a committed token."""
        rs = np.random.RandomState(6)
        NB, BS, H, KVH, D, B, C = 9, 4, 8, 2, 16, 2, 3
        kc = torch.as_tensor(rs.randn(NB, BS, KVH, D)).bfloat16()
        vc = torch.as_tensor(rs.randn(NB, BS, KVH, D)).bfloat16()
        q = torch.as_tensor(rs.randn(B, C, H, D)).bfloat16()
        tables = torch.tensor([[0, 3, 5, 8], [1, 2, 4, 8]])
        base = torch.tensor([5, 9])
        got = pa.paged_attention_verify(q, kc, vc, tables, base)
        for i in range(C):
            want = pa.paged_attention_decode_inner(q[:, i], kc, vc, tables,
                                                   base + i + 1)
            assert torch.equal(got[:, i], want)


class TestQuantizedKV:
    @pytest.mark.parametrize("fmt_name,tol",
                             [("int8", 0.03), ("fp8_e4m3", 0.06),
                              ("fp8_e5m2", 0.12)])
    def test_gqa_attention_read_close_to_native(self, fmt_name, tol):
        """Dequantizing paged decode attention on a GQA block layout stays
        within quantization tolerance of the native read."""
        rs = np.random.RandomState(1)
        NB, BS, NH, KVH, D, L = 5, 4, 4, 2, 16, 10
        fmt = pa.KVBlockFormat(fmt_name, native_dtype=torch.float32)
        table = torch.tensor([[0, 1, 2, 4]])
        k_seq = torch.as_tensor(rs.randn(L, KVH, D).astype(np.float32))
        v_seq = torch.as_tensor(rs.randn(L, KVH, D).astype(np.float32))
        q = torch.as_tensor(rs.randn(1, NH, D).astype(np.float32))
        kc = torch.zeros(NB, BS, KVH, D)
        vc = torch.zeros(NB, BS, KVH, D)
        pa.kv_write_chunk(None, kc, vc, None, None, k_seq, v_seq, table[0], 0)
        ref = pa.paged_attention_decode_inner(q, kc, vc, table,
                                              torch.tensor([L]),
                                              scale=D ** -0.5)
        qkc = torch.zeros(NB, BS, KVH, D).to(fmt.store_dtype)
        qvc = torch.zeros(NB, BS, KVH, D).to(fmt.store_dtype)
        ks = torch.zeros(NB, BS, KVH, dtype=fmt.scale_dtype)
        vs = torch.zeros(NB, BS, KVH, dtype=fmt.scale_dtype)
        pa.kv_write_chunk(fmt, qkc, qvc, ks, vs, k_seq, v_seq, table[0], 0)
        got = pa.paged_attention_decode_inner(
            q, qkc, qvc, table, torch.tensor([L]), scale=D ** -0.5,
            fmt=fmt, k_scale_cache=ks, v_scale_cache=vs)
        err = (got - ref).abs().max().item()
        assert err < tol, f"{fmt_name} attention error {err}"

    @pytest.mark.parametrize("fmt_name", ["int8", "fp8_e4m3"])
    def test_engine_quantized_gqa_streams(self, fmt_name):
        """int8/fp8 engines on a GQA llama give the reference engine's
        greedy streams, and speculation stays invisible within a
        format."""
        rs = np.random.RandomState(9)
        prompts = [rs.randint(0, 128, (7,)), rs.randint(0, 128, (10,))]
        want = _ref_run(("quant", fmt_name), prompts, 12, kv_heads=2,
                        decode_steps=3, kv_cache_dtype=fmt_name)
        port = _pair(kv_heads=2)[1]
        base = _run(ContinuousBatchingEngine, port, prompts, 12,
                    decode_steps=3, kv_cache_dtype=fmt_name)
        assert base == want
        assert [len(s) for s in base] == [12, 12]
        spec = _run(ContinuousBatchingEngine, port, prompts, 12,
                    decode_steps=3, kv_cache_dtype=fmt_name,
                    speculative_decode=True, draft_depth=2)
        assert spec == base, f"spec changed the {fmt_name} stream"

    def test_kv_dequant_fault_degrades_to_native(self):
        """The serve.kv_dequant fault site dequantizes the pool in place of
        a new native one, mid-run; every stream finishes."""
        from paddle_tpu_torch.resilience.faults import injected_faults
        port = _pair(kv_heads=2)[1]
        eng = ContinuousBatchingEngine(
            port, num_blocks=64, block_size=8, max_batch=4,
            prefill_buckets=(16,), decode_steps=3, kv_cache_dtype="int8",
            speculative_decode=True)
        rs = np.random.RandomState(9)
        rids = [eng.add_request(rs.randint(0, 128, (n,)), max_new_tokens=12)
                for n in (7, 10)]
        with injected_faults("serve.kv_dequant:2:TimeoutError"):
            out = eng.run()
        assert not eng.pool.fmt.quantized
        assert eng.pool.k.dtype == torch.float32 and eng.pool.k_scale is None
        assert [len(out[r]) for r in rids] == [12, 12]


class TestCapacity:
    def test_int8_fits_1p9x_lanes_in_same_bytes(self):
        """Same kv_pool_bytes budget: the int8 pool admits >=1.9x the
        sequences of bf16 before KVPoolExhaustedError (head_dim 64), and
        both size the pool as the reference does."""
        ref, port = _pair(kv_heads=2, hidden=256)
        budget = 1 << 20

        def lanes(Engine, model, fmt_name):
            eng = Engine(model, kv_cache_dtype=fmt_name,
                         kv_pool_bytes=budget, num_blocks=None,
                         block_size=8, max_batch=4, prefill_buckets=(16,))
            n = 0
            try:
                while True:
                    eng.pool.ensure(n, 64)       # one 64-token sequence
                    n += 1
            except MemoryError as e:     # each package's own subclass
                assert type(e).__name__ == "KVPoolExhaustedError"
                return n

        bf16, int8 = (lanes(ContinuousBatchingEngine, port, f)
                      for f in ("bf16", "int8"))
        assert int8 >= 1.9 * bf16, f"int8={int8} bf16={bf16}"
        assert (bf16, int8) == tuple(lanes(JEngine, ref, f)
                                     for f in ("bf16", "int8"))

"""The port's prefix cache (inference/prefix_cache.py and the engine's
copy-on-write block sharing) against the JAX package's, mirroring
tests/test_prefix_cache.py.

The index is a copy of a jax-free module: on the same inputs it gives the
reference's outputs. The engines serve the same requests in float32 with
the reference's weights (convert.py): greedy streams with the cache on,
cold and warm, through a COW fork and under eviction, must equal the
reference engine's and the port's cache-off streams token for token;
sampled streams are held to themselves with the cache on and off. After
every run the pool's refcounts close: no per-request table survives and
every remaining reference is one index pin.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import generation
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine, drafting
from paddle_tpu_torch.inference.prefix_cache import (PrefixCacheIndex,
                                                     affinity_key,
                                                     chain_keys)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

_PAIRS = {}
_REF = {}


def _pair(kv_heads=4):
    """(reference model, port model with the reference's weights), f32."""
    if kv_heads not in _PAIRS:
        cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=kv_heads,
                   max_position_embeddings=256)
        paddle.seed(0)
        ref = JLlama(JConfig(**cfg))
        port = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _PAIRS[kv_heads] = (ref, port)
    return _PAIRS[kv_heads]


def _engine(Engine, model, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", (16,))
    return Engine(model, **kw)


def _run(Engine, model, prompts, n, sample=False, **kw):
    eng = _engine(Engine, model, **kw)
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


def _dense(prompt, n):
    out = generation.generate(_pair()[1], torch.as_tensor(prompt)[None],
                              max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def _shared_mix(seed=0, head_len=16, tails=(3, 5, 8, 2)):
    """Four prompts sharing a block-aligned head: with max_batch=2 the
    first pair admits cold and the second pair warm within one run."""
    rs = np.random.RandomState(seed)
    head = rs.randint(1, 128, (head_len,))
    return [np.concatenate([head, rs.randint(1, 128, (t,))])
            for t in tails]


def _pool_closed(eng):
    """Refcount closure: no per-request tables, every block either free or
    referenced exactly once, by the prefix index."""
    pool = eng.pool
    assert pool.tables == {}, "per-request tables survived retirement"
    assert len(pool._free) + len(pool._ref) == pool.num_blocks - 1, \
        f"blocks leaked: free={len(pool._free)} ref={len(pool._ref)}"
    idx_blocks = (set() if eng._prefix is None else
                  {n.block for n in eng._prefix._nodes.values()})
    assert set(pool._ref) == idx_blocks, \
        "referenced blocks are not exactly the index pins"
    assert all(c == 1 for c in pool._ref.values()), \
        f"dangling extra references: {pool._ref}"


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


class TestIndexUnit:
    def test_lookup_insert_evict_roundtrip(self):
        rs = np.random.RandomState(1)
        p = rs.randint(1, 128, (20,)).astype(np.int32)
        q = p.copy()
        q[12] = (q[12] % 126) + 1
        trail = []
        for mod in (jpc, None):
            idx = (mod.PrefixCacheIndex("fmt:8", 8) if mod
                   else PrefixCacheIndex("fmt:8", 8))
            trail.append([idx.lookup(p), idx.insert(p, [4, 9, 13]),
                          len(idx), idx.lookup(p), idx.lookup(q),
                          idx.evict(protect=frozenset([9])), idx.evict(),
                          idx.evict(), idx.evict(), len(idx)])
        assert trail[1] == trail[0]
        assert trail[1] == [([], 0), [4, 9], 2, ([4, 9], 16), ([4], 8),
                            None, 9, 4, None, 0]

    def test_chain_keys_depend_on_identity_and_history(self):
        p = np.arange(1, 17, dtype=np.int32)
        for ident in ("fmt-a", "fmt-b"):
            assert ([k for k, _c in chain_keys(ident, 8, p)]
                    == [k for k, _c in jpc.chain_keys(ident, 8, p)])
        a = [k for k, _c in chain_keys("fmt-a", 8, p)]
        b = [k for k, _c in chain_keys("fmt-b", 8, p)]
        assert len(a) == 2 and a[0] != b[0]
        p2 = np.concatenate([p[8:], p[8:]])
        c = [k for k, _c in chain_keys("fmt-a", 8, p2)]
        assert c[1] != a[1]
        assert affinity_key("fmt-a", 8, p) == jpc.affinity_key("fmt-a", 8, p)
        assert affinity_key("fmt-a", 8, p[:5]) is None

    def test_trim_to_cap(self):
        p = np.arange(1, 25, dtype=np.int32)
        for Index in (PrefixCacheIndex, jpc.PrefixCacheIndex):
            idx = Index("fmt:8", 8, max_blocks=1)
            idx.insert(p, [0, 1, 2])
            dropped = idx.trim()
            assert len(idx) == 1 and dropped == [2, 1]
            assert idx.clear() == [0] and len(idx) == 0

    def test_engine_identity_string_matches_reference(self):
        ref, port = _pair(kv_heads=2)
        for fmt in ("bf16", "int8"):
            a = _engine(JEngine, ref, prefix_cache=True, kv_cache_dtype=fmt)
            b = _engine(ContinuousBatchingEngine, port, prefix_cache=True,
                        kv_cache_dtype=fmt)
            assert b._prefix.identity == a._prefix.identity


class TestByteIdentity:
    def test_greedy_cache_on_off_and_dense(self):
        prompts = _shared_mix()
        want = _ref_run("mix0", prompts, 10, prefix_cache=True)
        port = _pair()[1]
        off = _run(ContinuousBatchingEngine, port, prompts, 10)
        assert off == [_dense(p, 10) for p in prompts]
        on = _run(ContinuousBatchingEngine, port, prompts, 10,
                  prefix_cache=True)
        assert on == off == want

    def test_sampled_cache_on_off(self):
        port = _pair()[1]
        prompts = _shared_mix(seed=3)
        off = _run(ContinuousBatchingEngine, port, prompts, 8, sample=True)
        on = _run(ContinuousBatchingEngine, port, prompts, 8, sample=True,
                  prefix_cache=True)
        assert on == off, "prefix cache changed a sampled stream"

    @pytest.mark.parametrize("fmt_name", ["int8", "fp8_e4m3"])
    def test_quantized_cache_on_off(self, fmt_name):
        """Quantized sharing is exact: the same tokens at the same
        positions in one format store the same bytes."""
        prompts = _shared_mix(seed=5)
        want = _ref_run(("quant", fmt_name), prompts, 8, kv_heads=2,
                        kv_cache_dtype=fmt_name, prefix_cache=True)
        port = _pair(kv_heads=2)[1]
        off = _run(ContinuousBatchingEngine, port, prompts, 8,
                   kv_cache_dtype=fmt_name)
        on = _run(ContinuousBatchingEngine, port, prompts, 8,
                  kv_cache_dtype=fmt_name, prefix_cache=True)
        assert on == off == want, f"prefix cache changed the {fmt_name} stream"

    def test_warm_reuse_across_runs(self, enabled_obs):
        """One engine, the same mix twice: the second pass hits the warm
        index, saves prefill tokens, and streams stay the same; refcounts
        close after both passes."""
        prompts = _shared_mix(seed=7)
        eng = _engine(ContinuousBatchingEngine, _pair()[1], prefix_cache=True)
        rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        first = [eng.run()[r] for r in rids]
        hits0 = enabled_obs.metric("serving_prefix_hits_total").value
        saved0 = enabled_obs.metric(
            "serving_prefix_tokens_saved_total").value
        rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        second = [eng.run()[r] for r in rids]
        assert second == first == [_dense(p, 10) for p in prompts]
        hits = enabled_obs.metric("serving_prefix_hits_total").value
        saved = enabled_obs.metric(
            "serving_prefix_tokens_saved_total").value
        assert hits - hits0 == len(prompts), "warm pass missed the index"
        assert saved - saved0 >= len(prompts) * 16
        assert enabled_obs.metric(
            "serving_prefix_shared_blocks").value >= 2
        assert enabled_obs.metric("serving_prefix_misses_total").value >= 1
        _pool_closed(eng)


def _three_passes(Engine, model, p, n, **kw):
    """One engine serving the same prompt three times in a row: cold, a
    warm block-aligned full match (COW fork), and again over the shared
    block the fork left untouched."""
    eng = _engine(Engine, model, prefix_cache=True, **kw)
    out = []
    for _ in range(3):
        rid = eng.add_request(p, max_new_tokens=n)
        out.append(eng.run()[rid])
    return out, eng


class TestCopyOnWrite:
    def test_block_aligned_full_match_forks(self, enabled_obs):
        """A block-aligned prompt fully covered by the index forks the last
        matched block before its tail token is written — under speculative
        decode, whose rejected drafts roll back — and later requests
        reading the shared block stay exact."""
        rs = np.random.RandomState(11)
        p = rs.randint(1, 128, (16,))       # exactly 2 blocks at bs=8
        kw = dict(decode_steps=3, speculative_decode=True, draft_depth=2)
        if "cow" not in _REF:
            _REF["cow"] = _three_passes(JEngine, _pair()[0], p, 10, **kw)[0]
        got, eng = _three_passes(ContinuousBatchingEngine, _pair()[1], p, 10,
                                 **kw)
        assert got == _REF["cow"] == [_dense(p, 10)] * 3
        assert enabled_obs.metric(
            "serving_prefix_cow_forks_total").value >= 1, \
            "full-prefix match did not fork"
        _pool_closed(eng)

    def test_fork_copies_payload_and_scales_in_place(self):
        """fork_cow fills the new block inside the pool tensors the decode
        graphs hold: the same tensor objects, the old block's bytes."""
        eng = _engine(ContinuousBatchingEngine, _pair(kv_heads=2)[1],
                      kv_cache_dtype="int8", prefix_cache=True)
        pool = eng.pool
        pool.k[:, 3] = 7
        pool.k_scale[:, 3] = 0.5
        pool.adopt("a", [3])
        pool.adopt("b", [3])
        tensors = (pool.k, pool.v, pool.k_scale, pool.v_scale)
        new = pool.fork_cow("b", 0)
        assert new != 3 and pool.tables["b"] == [new]
        assert (pool.k, pool.v, pool.k_scale, pool.v_scale) == tensors
        assert torch.equal(pool.k[:, new], pool.k[:, 3])
        assert torch.equal(pool.k_scale[:, new], pool.k_scale[:, 3])
        assert pool.shared_count("a") == 0 and pool.fork_cow("a", 0) == 3

    def test_suffix_drafter_parity_cold_and_warm(self):
        """The suffix drafter under the prefix cache: cold and warm
        speculative streams both match the reference engine's."""
        from paddle_tpu.inference import drafting as jdrafting
        rs = np.random.RandomState(12)
        p = np.tile(rs.randint(1, 128, (5,)), 4)[:16]  # repetitive motif
        if "suffix" not in _REF:
            _REF["suffix"] = _three_passes(
                JEngine, _pair()[0], p, 10, decode_steps=3,
                speculative_decode=True, draft_depth=2,
                drafter=jdrafting.suffix_drafter())[0]
        got, eng = _three_passes(
            ContinuousBatchingEngine, _pair()[1], p, 10, decode_steps=3,
            speculative_decode=True, draft_depth=2,
            drafter=drafting.suffix_drafter())
        assert got == _REF["suffix"] == [_dense(p, 10)] * 3
        _pool_closed(eng)


class TestEviction:
    def test_pressure_evicts_lru_and_closes(self, enabled_obs):
        """A pool too small to hold both the index pins and a new request
        evicts LRU index blocks at admission; the new stream is exact and
        refcounts close."""
        rs = np.random.RandomState(13)
        a = rs.randint(1, 128, (16,))
        b = rs.randint(1, 128, (16,))
        # 5 blocks: scratch + 4 usable; one 22-token request needs 3
        eng = _engine(ContinuousBatchingEngine, _pair()[1],
                      prefix_cache=True, num_blocks=5, max_batch=1,
                      max_blocks_per_seq=3)
        eng.add_request(a, max_new_tokens=6)
        eng.run()
        assert len(eng._prefix) == 2        # a's head pinned (2 blocks)
        rid = eng.add_request(b, max_new_tokens=6)
        assert eng.run()[rid] == _dense(b, 6)
        assert enabled_obs.metric(
            "serving_prefix_evictions_total").value >= 1
        _pool_closed(eng)

    def test_cap_trims_after_insert(self):
        eng = _engine(ContinuousBatchingEngine, _pair()[1], prefix_cache=True,
                      prefix_cache_blocks=1)
        p = np.arange(1, 17, dtype=np.int32)
        eng.add_request(p, max_new_tokens=4)
        eng.run()
        assert len(eng._prefix) <= 1, "prefix_cache_blocks cap ignored"
        _pool_closed(eng)

    def test_index_fault_is_a_plain_miss(self, enabled_obs):
        """serve.prefix_match faults degrade to a cache miss: the stream
        is unchanged and counted."""
        from paddle_tpu_torch.resilience.faults import injected_faults
        prompts = _shared_mix(seed=2)
        eng = _engine(ContinuousBatchingEngine, _pair()[1], prefix_cache=True)
        rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        with injected_faults("serve.prefix_match:rand(0.5)@3:TimeoutError"):
            out = eng.run()
        assert [out[r] for r in rids] == [_dense(p, 6) for p in prompts]
        fam = obs.get_registry().get("serving_runtime_degradations_total")
        assert fam.labels(what="prefix_miss").value >= 1
        _pool_closed(eng)

    def test_kv_dequant_clears_the_index(self):
        eng = _engine(ContinuousBatchingEngine, _pair(kv_heads=2)[1],
                      prefix_cache=True, kv_cache_dtype="int8")
        eng.add_request(np.arange(1, 17), max_new_tokens=4)
        eng.run()
        assert len(eng._prefix) == 2
        eng._degrade_kv_to_bf16()
        assert len(eng._prefix) == 0
        _pool_closed(eng)

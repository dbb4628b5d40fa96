"""The port's continuous-batching engine (inference/serving.py) and its
chunked prefill against the JAX package's, mirroring tests/test_serving.py
and tests/test_serving_fused.py.

Both engines serve the same requests in float32 with the reference's
weights carried across (convert.py): greedy streams must be equal token for
token. Sampled decode tokens come from the port's own counter-based draw,
which cannot reproduce JAX's keys, so sampled streams are held to
themselves across decode_steps and runs; their first token, chosen on the
host from the same RandomState, must still equal the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.parallel.functional import split_stacked_layer_params
from paddle_tpu_torch import generation
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import (BackpressureError,
                                        ContinuousBatchingEngine,
                                        KVPoolExhaustedError, Request)
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as pa
from torch_one_thread import one_torch_thread  # noqa: F401

WIDTHS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=256)
# one chunk layer in f32: products over hidden 64 and softmax sums over
# the cached positions, in another order on each side
F32_TOL = 2e-5

_PAIRS = {}


def _pair(kv_heads=4, tied=False):
    """(reference model, port model with the reference's weights)."""
    key = (kv_heads, tied)
    if key not in _PAIRS:
        cfg = dict(WIDTHS, num_key_value_heads=kv_heads,
                   tie_word_embeddings=tied)
        paddle.seed(0)
        ref = JLlama(JConfig(**cfg))
        port = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _PAIRS[key] = (ref, port)
    return _PAIRS[key]


def _engine(Engine, model, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_buckets", (16,))
    return Engine(model, **kw)


def _both(scenario, kv_heads=4, tied=False):
    """scenario(Engine, model) run on the reference engine and the port's;
    returns (reference result, port result)."""
    ref, port = _pair(kv_heads, tied)
    return (scenario(JEngine, ref),
            scenario(ContinuousBatchingEngine, port))


def _serve(prompts, new, steps_between=None, late=None, **engine_kw):
    """A scenario: serve `prompts` (and, after `steps_between` steps, the
    `late` prompts); returns the streams in request order."""
    def scenario(Engine, model):
        eng = _engine(Engine, model, **engine_kw)
        rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
        if late:
            for _ in range(steps_between):
                eng.step()
            rids += [eng.add_request(p, max_new_tokens=n) for p, n in late]
        out = eng.run()
        return [out[r] for r in rids]
    return scenario


def _dense(model, prompt, n):
    """The port's greedy continuation from the dense-cache generate()."""
    out = generation.generate(model, torch.as_tensor(prompt)[None],
                              max_new_tokens=n)
    return out[0, len(prompt):].tolist()


@pytest.fixture
def both_obs():
    """The observability layer on in both packages, from zero."""
    for o in (obs, jobs):
        o.get_registry().reset()
        o.enable()
    yield
    for o in (obs, jobs):
        o.disable()
        o.get_registry().reset()


# -- tests/test_serving.py ---------------------------------------------------

@pytest.mark.parametrize("kv_heads", [4, 2])
def test_matches_dense_generate(kv_heads):
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 128, (7,)), rs.randint(0, 128, (13,))]
    want, got = _both(_serve(prompts, 6, prefill_buckets=(16, 32)),
                      kv_heads=kv_heads)
    assert got == want
    port = _pair(kv_heads)[1]
    assert got == [_dense(port, p, 6) for p in prompts]


def test_tied_embeddings():
    p = np.arange(5) % 128
    want, got = _both(_serve([p], 4, max_batch=2), tied=True)
    assert got == want
    assert got[0] == _dense(_pair(tied=True)[1], p, 4)


def test_midflight_admission():
    """A request added while another decodes produces the tokens it would
    alone."""
    rs = np.random.RandomState(1)
    p1, p2 = rs.randint(0, 128, (6,)), rs.randint(0, 128, (9,))
    want, got = _both(_serve([p1], 8, steps_between=3, late=[(p2, 5)]))
    assert got == want
    port = _pair()[1]
    assert got == [_dense(port, p1, 8), _dense(port, p2, 5)]


def test_blocks_freed_after_completion():
    def scenario(Engine, model):
        eng = _engine(Engine, model, num_blocks=16, max_batch=2)
        free0 = len(eng.pool._free)
        rid = eng.add_request(np.arange(6) % 128, max_new_tokens=3)
        out = eng.run()
        assert len(eng.pool._free) == free0
        assert eng.pool.tables == {}
        assert rid in eng.finished
        return out[rid]
    want, got = _both(scenario)
    assert got == want


def test_pool_exhaustion_queues_not_crashes():
    """4 blocks of 8: one 16-token sequence at a time despite 2 lanes."""
    p = np.random.RandomState(2).randint(0, 128, (10,))

    def scenario(Engine, model):
        eng = _engine(Engine, model, num_blocks=4, max_batch=2)
        r1 = eng.add_request(p, max_new_tokens=6)
        r2 = eng.add_request(p, max_new_tokens=6)
        eng.step()
        queued = len(eng.queue)
        out = eng.run()
        return queued, out[r1], out[r2]
    want, got = _both(scenario)
    assert got == want
    assert got[0] == 1 and got[1] == got[2]


@pytest.mark.parametrize("decode_steps", [4, 5])
def test_eos_stops_early(decode_steps):
    """EOS at its first occurrence, also inside a tile (the reference's
    test_serving.py:104 and, at decode_steps 5, test_serving_fused.py:84)."""
    p = np.arange(5) % 128
    ref = _dense(_pair()[1], p, 10)
    eos = ref[2]

    def scenario(Engine, model):
        eng = _engine(Engine, model, max_batch=2, num_blocks=32,
                      decode_steps=decode_steps)
        rid = eng.add_request(p, max_new_tokens=10, eos_token_id=eos)
        out = eng.run()
        return out[rid], eng.finished[rid].finish_reason
    want, got = _both(scenario)
    assert got == want
    assert got == (ref[:ref.index(eos) + 1], "eos")


def test_oversized_request_rejected():
    def scenario(Engine, model):
        eng = _engine(Engine, model, max_batch=2, max_blocks_per_seq=2)
        rid = eng.add_request(np.arange(10) % 128, max_new_tokens=20)
        eng.step()
        req = eng.finished[rid]
        return req.generated, req.finish_reason
    want, got = _both(scenario)
    assert got == want == ([], "rejected")


def test_top_p_filters_tail():
    """top_p -> 0 keeps only the argmax: the greedy stream."""
    p = np.arange(4) % 128
    port = _pair()[1]
    eng = _engine(ContinuousBatchingEngine, port, max_batch=2, num_blocks=32)
    rid = eng.add_request(p, max_new_tokens=4, do_sample=True, top_p=1e-9,
                          seed=5)
    assert eng.run()[rid] == _dense(port, p, 4)


def test_topk1_equals_greedy_and_seed_reproducible():
    port = _pair()[1]
    p = np.arange(6) % 128

    def run(**kw):
        eng = _engine(ContinuousBatchingEngine, port, max_batch=2,
                      num_blocks=32)
        rid = eng.add_request(p, max_new_tokens=5, **kw)
        return eng.run()[rid]
    assert run(do_sample=True, top_k=1, seed=3) == _dense(port, p, 5)
    assert run(do_sample=True, temperature=2.0, seed=11) == run(
        do_sample=True, temperature=2.0, seed=11)
    outs = {tuple(run(do_sample=True, temperature=5.0, seed=s))
            for s in range(6)}
    assert len(outs) > 1


# -- tests/test_serving_fused.py ---------------------------------------------

def test_greedy_byte_identical_across_decode_steps():
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 128, (7,)), rs.randint(0, 128, (13,))]
    want, base = _both(_serve(prompts, 9, decode_steps=1))
    assert base == want
    port = _pair()[1]
    for k in (3, 8):
        assert _serve(prompts, 9, decode_steps=k)(
            ContinuousBatchingEngine, port) == base


def test_gqa_lanes_match_dense():
    p = (np.arange(11) * 5) % 128
    want, got = _both(_serve([p], 7, decode_steps=4), kv_heads=2)
    assert got == want
    assert got[0] == _dense(_pair(2)[1], p, 7)


def test_seeded_sampling_reproducible_across_decode_steps():
    """The device draw is a pure function of (seed, position): the stream
    is the same at decode_steps 1, 4 and 7; its first token, chosen on the
    host, equals the reference's."""
    ref, port = _pair()
    p = np.arange(6) % 128

    def run(Engine, model, k, seed=11):
        eng = _engine(Engine, model, decode_steps=k)
        rid = eng.add_request(p, max_new_tokens=7, do_sample=True,
                              temperature=2.0, seed=seed)
        return eng.run()[rid]
    a = run(ContinuousBatchingEngine, port, 1)
    assert len(a) == 7
    assert run(ContinuousBatchingEngine, port, 4) == a
    assert run(ContinuousBatchingEngine, port, 7) == a
    assert a[0] == run(JEngine, ref, 4)[0]
    outs = {tuple(run(ContinuousBatchingEngine, port, 4, seed=s))
            for s in range(5)}
    assert len(outs) > 1


def test_mixed_greedy_and_sampled_lanes():
    rs = np.random.RandomState(3)
    pg, ps = rs.randint(0, 128, (6,)), rs.randint(0, 128, (9,))

    def scenario(Engine, model):
        eng = _engine(Engine, model, decode_steps=4)
        r_greedy = eng.add_request(pg, max_new_tokens=8)
        r_samp = eng.add_request(ps, max_new_tokens=8, do_sample=True,
                                 temperature=2.0, seed=7)
        out = eng.run()
        return out[r_greedy], out[r_samp]
    (want_g, want_s), (got_g, got_s) = _both(scenario)
    assert got_g == want_g == _dense(_pair()[1], pg, 8)
    assert len(got_s) == 8 and got_s[0] == want_s[0]
    # the sampled stream is the one a solo run produces
    eng = _engine(ContinuousBatchingEngine, _pair()[1], decode_steps=4)
    rid = eng.add_request(ps, max_new_tokens=8, do_sample=True,
                          temperature=2.0, seed=7)
    assert eng.run()[rid] == got_s


def test_chunked_matches_oneshot():
    p = np.random.RandomState(1).randint(0, 128, (24,))
    port = _pair()[1]

    def run(chunk):
        return _serve([p], 6, prefill_buckets=(32,), prefill_chunk=chunk,
                      decode_steps=2)
    want, oneshot = _both(run(32))
    assert oneshot == want
    assert run(8)(ContinuousBatchingEngine, port) == oneshot
    assert run(16)(ContinuousBatchingEngine, port) == oneshot
    assert oneshot[0] == _dense(port, p, 6)


def test_prompt_longer_than_largest_bucket_now_served():
    p = np.random.RandomState(2).randint(0, 128, (40,))

    def scenario(Engine, model):
        eng = _engine(Engine, model, decode_steps=2)
        rid = eng.add_request(p, max_new_tokens=5)
        out = eng.run()
        assert eng.pool.tables == {}
        return out[rid], eng.finished[rid].finish_reason
    want, got = _both(scenario)
    assert got == want
    assert got == (_dense(_pair()[1], p, 5), "length")


def test_chunked_prefill_interleaves_with_decode(both_obs):
    """Decode tiles keep dispatching between a long admission's chunks."""
    p1 = np.arange(6) % 128
    p2 = np.random.RandomState(4).randint(0, 128, (30,))

    def scenario(Engine, model):
        eng = _engine(Engine, model, decode_steps=1, prefill_chunk=8,
                      prefill_buckets=(8,))
        o = obs if Engine is ContinuousBatchingEngine else jobs
        reg = o.get_registry()
        r1 = eng.add_request(p1, max_new_tokens=12)
        for _ in range(2):
            eng.step()
        r2 = eng.add_request(p2, max_new_tokens=4)
        d0 = reg.get("serving_decode_dispatches_total").value
        eng.step()
        eng.step()
        assert reg.get("serving_prefill_chunks_total").value >= 2
        assert reg.get("serving_decode_dispatches_total").value > d0
        assert r2 not in eng.finished
        out = eng.run()
        return out[r1], out[r2]
    want, got = _both(scenario)
    assert got == want


def _serving_counters(o):
    reg = o.get_registry()
    names = ["serving_admitted_total", "serving_retired_total",
             "serving_tokens_total", "serving_lane_state_uploads_total",
             "serving_decode_dispatches_total",
             "serving_prefill_chunks_total"]
    out = {n: reg.get(n).value for n in names}
    out["hostsync_count"] = reg.get("serving_hostsync_seconds").count
    out["ttft_count"] = reg.get("serving_ttft_seconds").count
    # series at 0 are left from earlier tests in the same process (a reset
    # zeroes series and keeps them): a reason absent and a reason at 0 say
    # the same
    out["finished"] = {k: c.value for k, c in
                       reg.get("serving_finished_total").children().items()
                       if c.value}
    return out


def test_uploads_only_on_membership_change(both_obs):
    """Steady-state decode does not re-upload lane state; every counter of
    the run equals the reference engine's."""
    def scenario(Engine, model):
        eng = _engine(Engine, model, decode_steps=2)
        rid = eng.add_request(np.arange(7) % 128, max_new_tokens=13)
        out = eng.run()
        o = obs if Engine is ContinuousBatchingEngine else jobs
        return out[rid], _serving_counters(o)
    (want, want_c), (got, got_c) = _both(scenario)
    assert got == want and len(got) == 13
    assert got_c == want_c
    assert got_c["serving_lane_state_uploads_total"] == 1
    assert got_c["serving_decode_dispatches_total"] >= 6
    assert got_c["hostsync_count"] == got_c["serving_decode_dispatches_total"]


def test_dispatch_ahead_depth_reaches_one(both_obs):
    eng = _engine(ContinuousBatchingEngine, _pair()[1], decode_steps=2)
    eng.add_request(np.arange(7) % 128, max_new_tokens=12)
    eng.step()
    eng.step()
    assert obs.get_registry().get("serving_dispatch_ahead_depth").value == 1
    eng.run()


def test_pool_exhaustion_typed_and_counted(both_obs):
    eng = _engine(ContinuousBatchingEngine, _pair()[1], num_blocks=4)
    with pytest.raises(KVPoolExhaustedError) as ei:
        eng.pool.ensure(999, 1000)
    assert isinstance(ei.value, MemoryError)
    eng.pool.release(999)
    assert obs.get_registry().get("serving_pool_exhausted_total").value == 1


def test_compat_step_loop_reproduces_prefused_engine(both_obs):
    p = (np.arange(9) * 3) % 128

    def scenario(Engine, model):
        eng = _engine(Engine, model, compat_step_loop=True, decode_steps=8)
        assert eng.decode_steps == 1
        rid = eng.add_request(p, max_new_tokens=8)
        out = eng.run()
        assert not eng._inflight
        o = obs if Engine is ContinuousBatchingEngine else jobs
        return out[rid], _serving_counters(o)
    (want, want_c), (got, got_c) = _both(scenario)
    assert got == want == _dense(_pair()[1], p, 8)
    assert got_c == want_c
    assert (got_c["serving_lane_state_uploads_total"]
            == got_c["serving_decode_dispatches_total"] == 7)


# -- the port's own surface ---------------------------------------------------

def test_unported_methods_raise_and_no_cost_model():
    """No method is refused any more: the serving mesh's hooks are ported
    (tests/test_torch_mesh.py holds their records and streams against the
    reference's), and a malformed hand-off is a typed ValueError; before
    any dispatch the cost model holds no price and no calibration, as the
    reference's (test_torch_loadgen.py holds it after one)."""
    eng = _engine(ContinuousBatchingEngine, _pair()[1])
    assert eng.prefill_sink is None
    eng.prefill_sink = print
    assert eng.prefill_sink is print
    eng.prefill_sink = None
    with pytest.raises(ValueError, match="block format"):
        eng.import_kv({"fmt": "int8"})
    assert eng.adopt_identity(0, "t") is False
    assert eng.predicted_costs() == {}
    assert eng.predicted_service_seconds() is None


def test_prefill_chunk_layer_lora_matches_reference():
    """generation._llama_layer_prefill_chunk with a `lora=` delta (GQA
    4:2): h and the pool against the reference's."""
    ref, port = _pair(kv_heads=2)
    stacked, _ = split_stacked_layer_params(
        {k: v._data for k, v in ref.state_dict().items()})
    jlp = {k: v[0] for k, v in stacked.items()}
    tlp = dict(port.llama.layers[0].named_parameters())
    cfg = dict(eps=1e-5, theta=10000.0, heads=4, kv_heads=2, head_dim=16)
    rs = np.random.RandomState(12)
    lora = [rs.randn(*s).astype(np.float32) * 0.5
            for s in ((64, 4), (4, 64), (64, 4), (4, 32))]
    kc = np.zeros((9, 4, 2, 16), np.float32)
    row = np.array([2, 5, 0, 7, 8, 8], np.int32)
    h = rs.randn(1, 8, 64).astype(np.float32)
    jh, (jk, jv) = jgen._llama_layer_prefill_chunk(
        jlp, jnp.asarray(h), jnp.asarray(kc), jnp.asarray(kc),
        jnp.asarray(row), 0, cfg, lora=tuple(map(jnp.asarray, lora)))
    with torch.no_grad():
        th, (tk, tv) = generation._llama_layer_prefill_chunk(
            tlp, torch.as_tensor(h), torch.as_tensor(kc),
            torch.as_tensor(kc.copy()), torch.as_tensor(row), 0, cfg,
            lora=tuple(map(torch.as_tensor, lora)))
        plain, _ = generation._llama_layer_prefill_chunk(
            tlp, torch.as_tensor(h), torch.zeros(9, 4, 2, 16),
            torch.zeros(9, 4, 2, 16), torch.as_tensor(row), 0, cfg)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=F32_TOL,
                               atol=F32_TOL)
    assert not torch.allclose(th, plain)        # the delta really lands


def test_backpressure_deadline_cancel_and_adapter():
    port = _pair()[1]
    eng = _engine(ContinuousBatchingEngine, port, max_queue=2)
    eng.add_request(np.arange(5), max_new_tokens=3)
    eng.add_request(np.arange(5), max_new_tokens=3, deadline_s=0.0)
    with pytest.raises(BackpressureError):
        eng.add_request(np.arange(5), max_new_tokens=3)
    with pytest.raises(ValueError, match="priority"):
        eng.add_request(np.arange(5), priority="urgent")
    eng.step()
    assert eng.finished[1].finish_reason == "timeout"
    assert eng.finished[1].generated == []
    assert eng.cancel(0) and not eng.cancel(0)
    assert 0 not in eng.finished and eng.pool.tables == {}
    rid = eng.add_request(np.arange(5), max_new_tokens=3, adapter="fr")
    eng.run()
    assert eng.finished[rid].finish_reason == "rejected"


def test_request_choose_matches_reference():
    from paddle_tpu.inference.serving import Request as JRequest
    logits = np.random.RandomState(9).randn(128).astype(np.float32)
    for kw in (dict(), dict(do_sample=True, temperature=0.7, seed=4),
               dict(do_sample=True, top_k=5, top_p=0.8, seed=5)):
        a = Request(0, np.arange(3), 4, None, **kw)
        b = JRequest(0, np.arange(3), 4, None, **kw)
        assert [a.choose(logits) for _ in range(5)] == [
            b.choose(logits) for _ in range(5)]
        if "seed" in kw:
            assert a.sample_seed == b.sample_seed


def test_device_sample_is_a_function_of_seed_and_position():
    rs = np.random.RandomState(10)
    logits = torch.as_tensor(rs.randn(3, 128).astype(np.float32) * 3)
    seeds = torch.tensor([1, 2, 1])
    lens = torch.tensor([5, 5, 5])
    ones = torch.ones(3)
    draw = serving._device_sample(logits, seeds, lens, ones,
                                  torch.zeros(3, dtype=torch.long), ones)
    again = serving._device_sample(logits, seeds, lens, ones,
                                   torch.zeros(3, dtype=torch.long), ones)
    assert torch.equal(draw, again)
    # top_k 1 and top_p -> 0 both collapse to the argmax
    top1 = serving._device_sample(logits, seeds, lens, ones,
                                  torch.ones(3, dtype=torch.long), ones)
    topp = serving._device_sample(logits, seeds, lens, ones,
                                  torch.zeros(3, dtype=torch.long),
                                  torch.full((3,), 1e-9))
    assert torch.equal(top1, logits.argmax(-1))
    assert torch.equal(topp, logits.argmax(-1))
    # over many positions the draw follows the softmax
    flat = torch.zeros(1, 4)
    flat[0, 0] = np.log(3.0)                     # p = (1/2, 1/6, 1/6, 1/6)
    n = 6000
    hits = sum(int(serving._device_sample(
        flat, torch.tensor([7]), torch.tensor([pos]), torch.ones(1),
        torch.zeros(1, dtype=torch.long), torch.ones(1))) == 0
        for pos in range(n))
    assert abs(hits / n - 0.5) < 0.03


def test_prefill_chunk_layer_matches_reference():
    """generation._llama_layer_prefill_chunk: one layer over two chunks of
    a prompt into the paged pool (GQA 4:2), h and the pool against the
    reference's."""
    ref, port = _pair(kv_heads=2)
    stacked, _ = split_stacked_layer_params(
        {k: v._data for k, v in ref.state_dict().items()})
    jlp = {k: v[0] for k, v in stacked.items()}
    tlp = dict(port.llama.layers[0].named_parameters())
    cfg = dict(eps=1e-5, theta=10000.0, heads=4, kv_heads=2, head_dim=16)
    rs = np.random.RandomState(11)
    kc = np.zeros((9, 4, 2, 16), np.float32)
    row = np.array([2, 5, 0, 7, 8, 8], np.int32)
    jk, jv, tk, tv = (jnp.asarray(kc), jnp.asarray(kc), torch.as_tensor(kc),
                      torch.as_tensor(kc.copy()))
    for start, c in ((0, 8), (8, 6)):
        h = rs.randn(1, c, 64).astype(np.float32)
        jh, (jk, jv) = jgen._llama_layer_prefill_chunk(
            jlp, jnp.asarray(h), jk, jv, jnp.asarray(row), start, cfg)
        with torch.no_grad():
            th, (tk, tv) = generation._llama_layer_prefill_chunk(
                tlp, torch.as_tensor(h), tk, tv, torch.as_tensor(row), start,
                cfg)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(tk.numpy()[:8], np.asarray(jk)[:8],
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tv.numpy()[:8], np.asarray(jv)[:8],
                                   rtol=F32_TOL, atol=F32_TOL)


def test_layered_pool_reserves_and_releases():
    pool = serving._LayeredBlockPool(2, 6, 4, 2, 8, torch.float32, "cpu",
                                     fmt=pa.KVBlockFormat("native",
                                                          torch.float32))
    assert pool.scratch_block == 5 and pool.can_fit(20)
    assert pool.ensure("a", 9) == [0, 1, 2]
    assert not pool.can_fit(12) and pool.can_fit(12, have=1)
    pool.release("a")
    assert sorted(pool._free) == [0, 1, 2, 3, 4] and pool.tables == {}


def test_pool_sized_by_bytes_as_the_reference():
    def scenario(Engine, model):
        eng = _engine(Engine, model, kv_pool_bytes=300_000)
        return eng.pool.num_blocks, eng.pool.scratch_block
    want, got = _both(scenario)
    assert got == want

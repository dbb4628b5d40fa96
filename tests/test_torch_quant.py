"""The port's quantization stack against the JAX package's: nn.quant's
weight-only and LLM.int8 linear algebra, nn.quant.format's layers, QAT and
PTQ (quantization), generation.WeightOnlyGenerator, and
tools/bench_decode's CPU run of bench.py's decode legs.

Tolerances, each stated where it is used:
- int8 levels, scales and dequantized weights: equal bit for bit (the
  division in float32, rounding half to even in both packages);
- float32 matmuls: within 1e-6 of the largest |value| (summation order);
- llm_int8_linear: equal bit for bit (its int8 product is exact, and the
  outlier product here has one nonzero column);
- QAT/PTQ: observer scales equal bit for bit, outputs within 1e-5 of the
  largest |value|;
- WeightOnlyGenerator: int8 tensors bit for bit, greedy ids token for
  token.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import nn as jnn
from paddle_tpu.nn import quant as jq
import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.nn import quant as tq


def J(a):
    return paddle.to_tensor(np.asarray(a))


def T(a):
    return torch.as_tensor(np.asarray(a))


def N(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().numpy()


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# -- nn.quant ---------------------------------------------------------------

_CASES = [("weight_only_int8", -1), ("weight_only_int8", 64),
          ("weight_only_int8", 128), ("weight_only_int4", -1),
          ("weight_only_int4", 64), ("weight_only_int4", 128),
          ("llm.int8", -1)]


@pytest.mark.parametrize("algo,gs", _CASES)
def test_weight_quantize_dequantize_bit_for_bit(algo, gs):
    rs = np.random.RandomState(0)
    w = rs.randn(256, 48).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero channel
    jqw, js = jq.weight_quantize(J(w), algo=algo, group_size=gs)
    tqw, ts = tq.weight_quantize(T(w), algo=algo, group_size=gs)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(N(tqw), N(jqw))
    np.testing.assert_array_equal(N(ts), N(js))
    for out_dtype in ("float32", "float16"):
        jd = jq.weight_dequantize(jqw, js, algo=algo, out_dtype=out_dtype,
                                  group_size=gs)
        td = tq.weight_dequantize(tqw, ts, algo=algo, out_dtype=out_dtype,
                                  group_size=gs)
        np.testing.assert_array_equal(N(td), N(jd))


@pytest.mark.parametrize("algo,gs", _CASES[:6])
@pytest.mark.parametrize("with_bias", [False, True])
def test_weight_only_linear(algo, gs, with_bias):
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 128).astype(np.float32)
    w = rs.randn(128, 32).astype(np.float32)
    b = rs.randn(32).astype(np.float32) if with_bias else None
    q, s = tq.weight_quantize(T(w), algo=algo, group_size=gs)
    wd = "int4" if algo.endswith("int4") else "int8"
    got = tq.weight_only_linear(T(x), q, None if b is None else T(b), s,
                                weight_dtype=wd, group_size=gs)
    want = jq.weight_only_linear(J(x), J(N(q)), None if b is None else J(b),
                                 J(N(s)), weight_dtype=wd, group_size=gs)
    _close(N(got), N(want))        # float32 matmul: 1e-6 of the largest


@pytest.mark.parametrize("outliers", [0, 1, 2])
@pytest.mark.parametrize("with_scale", [False, True])
def test_llm_int8_linear_exact(outliers, with_scale):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, 64).astype(np.float32)
    for c in (7, 40)[:outliers]:
        x[0, 1, c] = 20.0 + c          # one outlier column each
    w = rs.randn(64, 24).astype(np.float32)
    b = rs.randn(24).astype(np.float32)
    q, s = tq.weight_quantize(T(w), algo="llm.int8")
    got = tq.llm_int8_linear(T(x), q, T(b), s if with_scale else None)
    want = jq.llm_int8_linear(J(x), J(N(q)), J(b),
                              J(N(s)) if with_scale else None)
    if outliers <= 1:
        np.testing.assert_array_equal(N(got), N(want))
    else:   # two outlier columns: a float32 sum of two products
        _close(N(got), N(want))


def test_llm_int8_product_is_exact_at_large_k():
    """|sum| passes 2**24 at k = 4096: the int32 product is exact."""
    a = torch.full((2, 4096), 127, dtype=torch.int8)
    w = torch.full((3, 4096), -128, dtype=torch.int8)
    got = tq._int8_matmul(a, w)
    assert got.dtype == torch.int32
    assert int(got[0, 0]) == 127 * -128 * 4096


def test_stub_and_guards():
    st = tq.Stub()
    x = torch.ones(2, 2)
    assert st(x) is x
    with pytest.raises(ValueError):
        tq.weight_quantize(x, algo="bogus")
    with pytest.raises(ValueError):
        tq.weight_quantize(x, group_size=32)
    with pytest.raises(ValueError):
        tq.weight_quantize(torch.ones(100, 4), group_size=64)
    with pytest.raises(ValueError):
        tq.weight_only_linear(x, x.to(torch.int8), weight_dtype="int2")


# -- nn.quant.format: the cases of test_quant_infer_profiler.TestQuantFormat

def _x():
    return np.random.RandomState(0).randn(8, 16).astype("float32")


@pytest.mark.parametrize("bits", [8, 4, (4, 3), (5, 2)])
def test_quanter_dequanter_match_reference(bits):
    x = _x()
    s = np.abs(x).max(axis=0)
    jqv = jq.LinearQuanter(J(s), quant_axis=1, bit_length=bits)(J(x))
    tqv = tq.LinearQuanter(T(s), quant_axis=1, bit_length=bits)(T(x))
    np.testing.assert_array_equal(N(tqv), N(jqv))
    jd = jq.LinearDequanter(J(s), quant_axis=1, bit_length=bits)(jqv)
    td = tq.LinearDequanter(T(s), quant_axis=1, bit_length=bits)(tqv)
    np.testing.assert_array_equal(N(td), N(jd))
    if bits == 8:
        qv = N(tqv)
        assert np.allclose(qv, np.round(qv)) and qv.max() <= 127
        assert np.abs(N(td) - x).max() <= s.max() / 127 + 1e-6


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fake_fp8_match_reference(fmt):
    x = _x() * 30
    for s in (np.float32(50.0), np.abs(x).max(axis=0)):
        jv = jq.fake_fp8_quant(J(x), J(s), axis=1, type=fmt)
        tv = tq.fake_fp8_quant(T(x), T(s), axis=1, type=fmt)
        np.testing.assert_array_equal(N(tv), N(jv))
        np.testing.assert_array_equal(
            N(tq.fake_fp8_dequant(tv, T(s), axis=1, type=fmt)),
            N(jq.fake_fp8_dequant(jv, J(s), axis=1, type=fmt)))
    q = N(tq.LinearQuanter(T(np.float32(np.abs(x).max())),
                           bit_length=(4, 3))(T(x)))
    np.testing.assert_array_equal(
        torch.as_tensor(q).to(torch.float8_e4m3fn).float().numpy(), q)


def test_reference_qmin_level_interop():
    s = torch.tensor(2.0)
    levels = torch.tensor([-128.0, -127.0, 0.0, 127.0])
    d = tq.LinearDequanter(s, bit_length=8)(levels)
    np.testing.assert_allclose(
        d.numpy(), np.array([-128, -127, 0, 127], np.float32) * 2.0 / 127)
    q = tq.LinearQuanter(s, bit_length=8)(d)
    np.testing.assert_allclose(q.numpy(), [-127.0, -127.0, 0.0, 127.0])


def test_per_channel_zero_point_and_groups_match_reference():
    x = np.random.RandomState(1).rand(2, 3).astype("float32") - 0.5
    s, z = np.array([1.0, 2.0], np.float32), np.array([10.0, 20.0],
                                                      np.float32)
    jv = jq.LinearQuanter(J(s), zero_point=J(z), quant_axis=0)(J(x))
    tv = tq.LinearQuanter(T(s), zero_point=T(z), quant_axis=0)(T(x))
    np.testing.assert_array_equal(N(tv), N(jv))
    np.testing.assert_array_equal(
        N(tq.LinearDequanter(T(s), zero_point=T(z), quant_axis=0)(tv)),
        N(jq.LinearDequanter(J(s), zero_point=J(z), quant_axis=0)(jv)))
    # group-wise: one row of scales per 4 input rows
    xg = np.random.RandomState(2).randn(10, 3).astype("float32")
    sg = np.abs(np.random.RandomState(3).randn(3, 3)).astype("float32")
    np.testing.assert_array_equal(
        N(tq.LinearQuanter(T(sg), group_size=4)(T(xg))),
        N(jq.LinearQuanter(J(sg), group_size=4)(J(xg))))


def test_format_guards():
    with pytest.raises(NotImplementedError):
        tq.LinearQuanter(np.ones(1), bit_length=(3, 4), device="cpu")
    q = tq.LinearQuanter(np.ones((2, 3), np.float32), bit_length=(4, 3),
                         device="cpu")
    with pytest.raises(NotImplementedError):
        q(torch.ones(256, 3))
    with pytest.raises(NotImplementedError):
        tq.LinearQuanter(np.ones(3, np.float32),
                         zero_point=np.array([1.0, 0.0, 0.0]),
                         bit_length=(4, 3), device="cpu")
    assert tq.fp8_limits("e5m2") == (57344.0, "float8_e5m2")


@pytest.mark.parametrize("x", [_x(), np.array([3.0, -4.0], np.float32),
                               None], ids=["batch", "below_range", "zero"])
def test_from_quanter_matches_qat(x):
    from paddle_tpu.quantization import FakeQuanterWithAbsMaxObserver as JFQ
    from paddle_tpu_torch.quantization import (
        FakeQuanterWithAbsMaxObserver as TFQ)
    observe = x is not None
    x = np.array([1.0, -2.0], np.float32) if x is None else x
    jf, tf = JFQ(), TFQ(device="cpu")
    if observe:
        jfake, tfake = jf(J(x)), tf(T(x))
        np.testing.assert_array_equal(N(tfake), N(jfake))
    out = tq.LinearQuanterDequanter.from_quanter(tf)(T(x))
    np.testing.assert_array_equal(
        N(out), N(jq.LinearQuanterDequanter.from_quanter(jf)(J(x))))
    if not observe:   # scale 0: the data passes through
        np.testing.assert_array_equal(N(out), x)


# -- quantization: QAT and PTQ on test_quant_infer_profiler's Net ----------

class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.relu = jnn.ReLU()
        self.fc2 = jnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))


class TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = pt.nn.Linear(16, 32, device="cpu")
        self.relu = pt.nn.ReLU()
        self.fc2 = pt.nn.Linear(32, 4, device="cpu")

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))


def _state(m):
    return {k: np.asarray(v._data) for k, v in m.state_dict().items()}


def _nets(seed):
    paddle.seed(seed)
    jm, tm = JNet(), TNet()
    load_reference_state(tm, _state(jm))
    return jm, tm


def _scales(state):
    return {k: v for k, v in state.items() if k.endswith("_scale")}


def test_qat_scales_outputs_and_grads_match_reference():
    from paddle_tpu import quantization as JQ
    from paddle_tpu_torch import quantization as TQ
    jm, tm = _nets(0)
    jqm = JQ.QAT(JQ.QuantConfig(JQ.FakeQuanterWithAbsMaxObserver,
                                JQ.FakeQuanterWithAbsMaxObserver)).quantize(jm)
    tqm = TQ.QAT(TQ.QuantConfig(TQ.FakeQuanterWithAbsMaxObserver,
                                TQ.FakeQuanterWithAbsMaxObserver)).quantize(tm)
    assert type(tqm.fc1).__name__ == "QuantedLinear"
    assert type(tm.fc1) is pt.nn.Linear          # the original is kept
    assert sorted(tqm.state_dict()) == sorted(jqm.state_dict())
    rng = np.random.RandomState(0)
    for _ in range(3):                            # EMA observers train
        x = rng.randn(8, 16).astype(np.float32)
        jout, tout = jqm(J(x)), tqm(T(x))
        _close(N(tout), N(jout), 1e-5)
    js, ts = _scales(_state(jqm)), _scales(
        {k: v.numpy() for k, v in tqm.state_dict().items()})
    assert js.keys() == ts.keys() and len(js) == 4
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    # the straight-through gradient
    x = rng.randn(8, 16).astype(np.float32)
    jl = jqm(J(x)).square().mean()
    jl.backward()
    tl = tqm(T(x)).square().mean()
    tl.backward()
    _close(tqm.fc1._inner.weight.grad.numpy(),
           np.asarray(jqm.fc1._inner.weight.grad._data), 1e-5)
    # converted (eval: frozen scales) against the reference's
    jc, tc = JQ.QAT(None).convert(jqm), TQ.QAT(None).convert(tqm)
    x = rng.randn(8, 16).astype(np.float32)
    _close(N(tc(T(x))), N(jc(J(x))), 1e-5)
    assert tc.fc1.weight_quanter._observer._scale == \
        tqm.fc1.weight_quanter._observer._scale


def test_ptq_calibrate_convert_match_reference():
    from paddle_tpu import quantization as JQ
    from paddle_tpu_torch import quantization as TQ
    jm, tm = _nets(1)
    jp = JQ.PTQ(JQ.QuantConfig(JQ.AbsmaxObserver, JQ.AbsmaxObserver))
    tp = TQ.PTQ(TQ.QuantConfig(TQ.AbsmaxObserver, TQ.AbsmaxObserver))
    jo, to = jp.quantize(jm), tp.quantize(tm)
    assert sorted(to.state_dict()) == sorted(jo.state_dict())
    rng = np.random.RandomState(1)
    for _ in range(4):
        x = rng.randn(8, 16).astype(np.float32)
        jo(J(x))
        to(T(x))
    for k, v in _scales(_state(jo)).items():
        np.testing.assert_array_equal(to.state_dict()[k].numpy(), v)
    jc, tc = jp.convert(jo), tp.convert(to)
    assert sorted(tc.state_dict()) == sorted(jc.state_dict())
    x = rng.randn(8, 16).astype(np.float32)
    _close(N(tc(T(x))), N(jc(J(x))), 1e-5)
    assert float(tc.fc1.weight_quanter.scales()) > 0


def test_calibrated_reference_carries_across():
    """A reference model PTQ calibrated, its state (scales included)
    loaded into the port's converted model: the same outputs."""
    from paddle_tpu import quantization as JQ
    from paddle_tpu_torch import quantization as TQ
    jm, tm = _nets(2)
    jp = JQ.PTQ(JQ.QuantConfig(JQ.AbsmaxObserver, JQ.AbsmaxObserver))
    jo = jp.quantize(jm)
    jo(J(np.random.RandomState(2).randn(8, 16).astype(np.float32) * 3))
    jc = jp.convert(jo)
    tp = TQ.PTQ(TQ.QuantConfig(TQ.AbsmaxObserver, TQ.AbsmaxObserver))
    tc = tp.convert(tp.quantize(tm))       # uncalibrated port scales ...
    load_reference_state(tc, _state(jc))   # ... replaced by the reference's
    x = np.random.RandomState(3).randn(8, 16).astype(np.float32)
    _close(N(tc(T(x))), N(jc(J(x))), 1e-5)


def test_layer_config_resolves_after_deepcopy_and_type_config():
    from paddle_tpu_torch import quantization as TQ
    _, tm = _nets(3)
    cfg = TQ.QuantConfig()
    cfg.add_layer_config(tm.fc2, weight=TQ.AbsmaxObserver)
    q = TQ.QAT(cfg).quantize(tm)          # a deepcopy, walked in lock step
    assert type(q.fc1) is pt.nn.Linear
    assert type(q.fc2).__name__ == "QuantedLinear"
    assert not hasattr(q.fc2, "activation_quanter")
    cfg = TQ.QuantConfig()
    cfg.add_type_config(pt.nn.Linear,
                        activation=lambda: TQ.EMAObserver(moving_rate=0.5,
                                                          device="cpu"))
    q = TQ.QAT(cfg).quantize(tm, inplace=True)
    assert q is tm and type(tm.fc1).__name__ == "QuantedLinear"
    assert tm.fc1.activation_quanter._rate == 0.5


def test_quanted_conv2d_matches_reference():
    from paddle_tpu import quantization as JQ
    from paddle_tpu_torch import quantization as TQ
    paddle.seed(4)
    jc = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1))
    tc = pt.nn.Sequential(pt.nn.Conv2D(3, 4, 3, padding=1, device="cpu"))
    load_reference_state(tc, _state(jc))
    jq_ = JQ.QAT(JQ.QuantConfig(JQ.FakeQuanterWithAbsMaxObserver,
                                JQ.FakeQuanterWithAbsMaxObserver)).quantize(jc)
    tq_ = TQ.QAT(TQ.QuantConfig(TQ.FakeQuanterWithAbsMaxObserver,
                                TQ.FakeQuanterWithAbsMaxObserver)).quantize(tc)
    x = np.random.RandomState(5).randn(2, 3, 6, 6).astype(np.float32)
    _close(N(tq_(T(x))), N(jq_(J(x))), 1e-5)


def test_quanter_registers_and_refuses_a_taken_name():
    from paddle_tpu_torch import quantization as TQ

    @TQ.quanter("MyQuanterForTest")
    class Mine(TQ.BaseQuanter):
        pass
    assert TQ.MyQuanterForTest is Mine
    with pytest.raises(ValueError):
        TQ.quanter("QAT")(Mine)


# -- generation.WeightOnlyGenerator ----------------------------------------

def _llama_pair(seed, **kw):
    paddle.seed(seed)
    ref = paddle.models.llama_tiny(num_hidden_layers=2, **kw)
    port = pt.models.llama_tiny(device="cpu", num_hidden_layers=2, **kw)
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("tied", [True, False])
def test_weight_only_generator_matches_reference(tied):
    ref, port = _llama_pair(3, tie_word_embeddings=tied,
                            num_key_value_heads=2)
    jw = jgen.WeightOnlyGenerator(ref, max_new_tokens=5)
    tw = generation.WeightOnlyGenerator(port, max_new_tokens=5)
    for k in jw._q:                  # stacked (L, in, out) against per layer
        for i in range(2):
            np.testing.assert_array_equal(tw._q[i][k].numpy(),
                                          np.asarray(jw._q[k][i]))
            np.testing.assert_array_equal(tw._s[i][k].numpy(),
                                          np.asarray(jw._s[k][i]))
    if not tied:
        np.testing.assert_array_equal(tw._qh.numpy(), np.asarray(jw._qh))
        np.testing.assert_array_equal(tw._sh.numpy(), np.asarray(jw._sh))
    assert tw.quantized_bytes() == jw.quantized_bytes()
    ids = np.random.RandomState(0).randint(0, 512, (2, 6))
    want = np.asarray(jw.generate(jnp.asarray(ids, jnp.int32))._data)
    got = tw.generate(torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_weight_only_generator_equals_generate_on_dequantized_weights():
    """The int8 stream is generate's on a model whose matmul weights are the
    generator's own dequantized tensors, token for token."""
    _, port = _llama_pair(5, tie_word_embeddings=False)
    tw = generation.WeightOnlyGenerator(port, max_new_tokens=6)
    layers, head = tw.dequantized_weights()
    copy_ = copy.deepcopy(port)
    with torch.no_grad():
        for layer, lp in zip(copy_.llama.layers, layers):
            for k, p in layer.named_parameters():
                p.copy_(lp[k])
        copy_.lm_head.weight.copy_(head)
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, 512, (2, 4)))
    torch.testing.assert_close(
        tw.generate(ids), generation.generate(copy_, ids, max_new_tokens=6),
        rtol=0, atol=0)


def test_share_weights_from_and_guards():
    _, port = _llama_pair(6)
    w1 = generation.WeightOnlyGenerator(port, max_new_tokens=1)
    w2 = generation.WeightOnlyGenerator(port, max_new_tokens=5,
                                        share_weights_from=w1)
    for i in range(len(w1._q)):
        for k in w1._q[i]:
            assert w2._q[i][k] is w1._q[i][k]     # no requantize
    ids = torch.ones(1, 4, dtype=torch.long)
    assert w1.generate(ids).shape == (1, 5)
    torch.testing.assert_close(w2.generate(ids)[:, :5], w1.generate(ids),
                               rtol=0, atol=0)
    # sampled streams repeat under one seed
    ws = generation.WeightOnlyGenerator(port, max_new_tokens=4,
                                        do_sample=True, top_k=5,
                                        share_weights_from=w1)
    torch.testing.assert_close(ws.generate(ids, seed=7),
                               ws.generate(ids, seed=7), rtol=0, atol=0)
    with pytest.raises(TypeError):
        generation.WeightOnlyGenerator(pt.models.gpt_tiny(device="cpu"))
    with pytest.raises(NotImplementedError):
        generation.WeightOnlyGenerator(port, algo="weight_only_int4")
    # the snapshot holds: a later change to the model does not reach it
    before = w1.generate(ids)
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(-1.0)
    torch.testing.assert_close(w1.generate(ids), before, rtol=0, atol=0)


def test_quantized_bytes_at_bench_decode_config():
    """bench.py's CUDA decode configuration comes to 574.3 MiB int8 by the
    reference's formula; counted from the shapes here (the card's run
    prints the measured figure)."""
    from paddle_tpu_torch.tools.bench_decode import bench_config
    cfg, *_ = bench_config("cuda")
    h, f, L, v = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    layer_int8 = L * (4 * h * h + 3 * h * f)
    scales = 4 * (L * (4 * h + 2 * f + h) + v)
    total = layer_int8 + scales + 2 * (2 * L * h + h) + 2 * v * h + h * v
    assert (layer_int8, total) == (404750336, 602235904)
    assert round(total / 2**20, 1) == 574.3


def test_bench_decode_cpu_returns_bench_keys():
    from paddle_tpu_torch.tools import bench_decode
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = bench_decode.run_one("cpu")
    finally:
        torch.set_num_threads(threads)
    for k in ("decode_batch", "decode_prompt", "decode_new_tokens",
              "decode_params", "decode_prefill_ms", "decode_per_token_ms",
              "decode_tokens_per_s", "decode_int8_per_token_ms",
              "decode_int8_tokens_per_s", "decode_int8_weight_mb"):
        assert k in r, k
    assert (r["decode_batch"], r["decode_prompt"],
            r["decode_new_tokens"]) == (2, 16, 8)
    assert r["decode_per_token_ms"] > 0 and r["decode_int8_tokens_per_s"] > 0
    assert r["ids"].shape == r["int8_ids"].shape == (2, 24)
    # the reference's int8 snapshot of the same configuration, in MiB
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    ref = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=256))
    jw = jgen.WeightOnlyGenerator(ref, max_new_tokens=8)
    assert r["quantized_bytes"] == jw.quantized_bytes()
    assert r["decode_int8_weight_mb"] == round(jw.quantized_bytes() / 2**20,
                                               1)

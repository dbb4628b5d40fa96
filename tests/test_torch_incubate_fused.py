"""incubate.nn's fused serving functionals and layers against the JAX
package's, on the cases of tests/test_utils_asp_fused.py (TestFusedLayers,
TestFusedTransformerFunctionals, TestFusedServingFunctionals),
tests/test_longtail_residue.py (varlen attention, FusedMultiTransformer)
and tests/test_moe_paged.py (block_multihead_attention).

Tolerance: float32, within 1e-5 of the largest |value| of the reference's
output. Dropout is off (rate 0 or training=False), or held to its own
properties: a kept fraction near 1 - p and kept entries scaled by
1 / (1 - p). Every guard raises where the reference's raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
from paddle_tpu.incubate.nn import functional as JIF
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.incubate import nn as tinc
from paddle_tpu_torch.incubate.nn import functional as TIF


def J(a):
    return None if a is None else paddle.Tensor(jnp.asarray(a))


def T(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def N(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().numpy()


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _rs(seed):
    return np.random.RandomState(seed)


def _f(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _carry(jlayer, tlayer):
    load_reference_state(tlayer, {k: np.asarray(v._data)
                                  for k, v in jlayer.state_dict().items()})


# -- functionals ------------------------------------------------------------

@pytest.mark.parametrize("pre", [True, False])
@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
def test_fused_feedforward(pre, act):
    rs = _rs(0)
    x, w1, w2 = _f(rs, 2, 5, 8), _f(rs, 8, 16, scale=0.1), \
        _f(rs, 16, 8, scale=0.1)
    b1, b2 = _f(rs, 16, scale=0.1), _f(rs, 8, scale=0.1)
    g, bl = _f(rs, 8), _f(rs, 8)
    args = lambda C: dict(ln1_scale=C(g), ln1_bias=C(bl), ln2_scale=C(g),
                          ln2_bias=C(bl), dropout1_rate=0.0,
                          dropout2_rate=0.0, activation=act,
                          pre_layer_norm=pre, training=False)
    want = JIF.fused_feedforward(J(x), J(w1), J(w2), J(b1), J(b2), **args(J))
    got = TIF.fused_feedforward(T(x), T(w1), T(w2), T(b1), T(b2), **args(T))
    _close(N(got), N(want))


@pytest.mark.parametrize("pre", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_multi_head_attention(pre, transpose, masked):
    rs = _rs(1)
    b, s, e, nh = 2, 4, 8, 2
    x = _f(rs, b, s, e)
    qkv_w = (_f(rs, e, 3 * e, scale=0.2) if transpose
             else _f(rs, 3, nh, e // nh, e, scale=0.2))
    qkv_b = _f(rs, 3 * e, scale=0.1) if transpose else \
        _f(rs, 3, nh, e // nh, scale=0.1)
    lin_w, lin_b = _f(rs, e, e, scale=0.2), _f(rs, e, scale=0.1)
    mask = _f(rs, b, 1, s, s) if masked else None
    lns = [_f(rs, e) for _ in range(4)]
    kw = lambda C: dict(pre_layer_norm=pre, pre_ln_scale=C(lns[0]),
                        pre_ln_bias=C(lns[1]), ln_scale=C(lns[2]),
                        ln_bias=C(lns[3]), qkv_bias=C(qkv_b),
                        linear_bias=C(lin_b), attn_mask=C(mask),
                        dropout_rate=0.0, attn_dropout_rate=0.0,
                        training=True, num_heads=nh,
                        transpose_qkv_wb=transpose)
    want = JIF.fused_multi_head_attention(J(x), J(qkv_w), J(lin_w), **kw(J))
    got = TIF.fused_multi_head_attention(T(x), T(qkv_w), T(lin_w), **kw(T))
    _close(N(got), N(want))


def test_fused_multi_head_attention_guards_and_dropout():
    x = torch.randn(2, 4, 8)
    w, lw = torch.randn(3, 2, 4, 8), torch.randn(8, 8)
    with pytest.raises(NotImplementedError):
        TIF.fused_multi_head_attention(x, w, lw, cache_kv=x)
    with pytest.raises(ValueError):
        TIF.fused_multi_head_attention(x, torch.randn(8, 24), lw,
                                       transpose_qkv_wb=True)
    pt.seed(0)
    a = TIF.fused_multi_head_attention(x, w, lw, dropout_rate=0.5,
                                       attn_dropout_rate=0.5)
    pt.seed(0)
    b = TIF.fused_multi_head_attention(x, w, lw, dropout_rate=0.5,
                                       attn_dropout_rate=0.5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)   # its own draws
    c = TIF.fused_multi_head_attention(x, w, lw, training=False)
    assert not torch.allclose(a, c)


def test_masked_multihead_attention_decode_steps():
    rs = _rs(2)
    b, nh, hd, max_len = 2, 2, 4, 8
    jc = jnp.zeros((2, b, nh, max_len, hd), jnp.float32)
    tc = torch.zeros(2, b, nh, max_len, hd)
    bias = _f(rs, 3, nh, hd, scale=0.1)
    for t in range(3):
        qkv = _f(rs, b, 3 * nh * hd)
        lens = np.full((b, 1), t, np.int32)
        smask = _f(rs, b, 1, 1, max_len, scale=0.1)
        jout, jc_t = JIF.masked_multihead_attention(
            J(qkv), paddle.Tensor(jc), bias=J(bias), src_mask=J(smask),
            sequence_lengths=J(lens))
        tout, tc_t = TIF.masked_multihead_attention(
            T(qkv), tc, bias=T(bias), src_mask=T(smask),
            sequence_lengths=T(lens))
        assert tc_t is tc                       # written in place
        _close(N(tout), N(jout))
        np.testing.assert_array_equal(tc.numpy(), N(jc_t))
        jc = jc_t._data
    for kw in (dict(beam_cache_offset=tc), dict(qkv_out_scale=tc),
               dict(out_shift=tc), dict(out_smooth=tc),
               dict(cum_offsets=tc), dict(rotary_tensor=tc),
               dict(rotary_emb_dims=1)):
        with pytest.raises(NotImplementedError):
            TIF.masked_multihead_attention(T(qkv), tc, **kw)
    with pytest.raises(ValueError):
        TIF.masked_multihead_attention(T(qkv))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_variable_length_memory_efficient_attention(causal, masked):
    rs = _rs(3)
    b, h, sq, sk, d = 2, 2, 5, 7, 8
    q, k, v = _f(rs, b, h, sq, d), _f(rs, b, h, sk, d), _f(rs, b, h, sk, d)
    sl = np.array([5, 3], np.int32)
    kl = np.array([7, 4], np.int32)
    mask = _f(rs, b, 1, sq, sk, scale=0.1) if masked else None
    want = JIF.variable_length_memory_efficient_attention(
        J(q), J(k), J(v), J(sl), J(kl), mask=J(mask), scale=0.3,
        causal=causal)
    got = TIF.variable_length_memory_efficient_attention(
        T(q), T(k), T(v), T(sl), T(kl), mask=T(mask), scale=0.3,
        causal=causal)
    _close(N(got), N(want))


@pytest.mark.parametrize("kvh,lens", [(4, [1, 1]), (2, [6, 9])])
def test_block_multihead_attention(kvh, lens):
    """test_moe_paged.py's first-token case (the output is v_new) and a
    GQA case deeper in the pages."""
    rs = _rs(6)
    B, H, D, bs, num_blocks, mb = 2, 4, 8, 4, 16, 3
    kc = _f(rs, num_blocks, bs, kvh, D)
    vc = _f(rs, num_blocks, bs, kvh, D)
    tables = np.arange(B * mb).reshape(B, mb).astype(np.int32)
    lens = np.array(lens, np.int32)
    qkv = _f(rs, B, (H + 2 * kvh) * D)
    jout, jk, jv = JIF.block_multihead_attention(
        J(qkv), J(kc), J(vc), J(lens), J(tables))
    tk, tv = T(kc).clone(), T(vc).clone()
    tout, tk2, tv2 = TIF.block_multihead_attention(
        T(qkv), tk, tv, T(lens), T(tables).long())
    assert tk2 is tk and tv2 is tv              # written in place
    _close(N(tout), N(jout))
    np.testing.assert_array_equal(tk.numpy(), N(jk))
    np.testing.assert_array_equal(tv.numpy(), N(jv))
    if kvh == H and lens[0] == 1:
        v_new = qkv.reshape(B, H + 2 * kvh, D)[:, H + kvh:]
        np.testing.assert_allclose(N(tout).reshape(B, H, D), v_new,
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError):
        TIF.block_multihead_attention(T(qkv), tk, tv, T(lens), T(tables),
                                      rope_emb=tk)


@pytest.mark.parametrize("topk,norm", [(2, True), (1, False), (3, True)])
def test_fused_moe(topk, norm):
    rs = _rs(7)
    E, d, hdim = 4, 8, 16
    x = _f(rs, 2, 5, d)
    gw = _f(rs, d, E)                 # continuous scores: no top-k ties
    w1, b1 = _f(rs, E, d, hdim, scale=0.3), _f(rs, E, hdim, scale=0.1)
    w2, b2 = _f(rs, E, hdim, d, scale=0.3), _f(rs, E, d, scale=0.1)
    want = JIF.fused_moe(J(x), J(gw), J(w1), J(b1), J(w2), J(b2),
                         moe_topk=topk, norm_topk_prob=norm)
    got = TIF.fused_moe(T(x), T(gw), T(w1), T(b1), T(w2), T(b2),
                        moe_topk=topk, norm_topk_prob=norm)
    _close(N(got), N(want))


@pytest.mark.parametrize("tx,ty,bias", [(False, False, True),
                                        (False, True, False),
                                        (True, True, True)])
def test_fused_matmul_bias_and_linear(tx, ty, bias):
    rs = _rs(0)
    x = _f(rs, 2, 8, 4) if tx else _f(rs, 2, 4, 8)
    w = _f(rs, 6, 8) if ty else _f(rs, 8, 6)
    b = _f(rs, 6) if bias else None
    _close(N(TIF.fused_matmul_bias(T(x), T(w), T(b), tx, ty)),
           N(JIF.fused_matmul_bias(J(x), J(w), J(b), tx, ty)))
    if not tx:
        _close(N(TIF.fused_linear(T(x), T(w), T(b), ty)),
               N(JIF.fused_linear(J(x), J(w), J(b), ty)))


@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
@pytest.mark.parametrize("tx,ty", [(False, False), (True, True)])
def test_fused_linear_activation(act, tx, ty):
    rs = _rs(1)
    x = _f(rs, 8, 4) if tx else _f(rs, 4, 8)
    w = _f(rs, 6, 8) if ty else _f(rs, 8, 6)
    b = _f(rs, 6)
    _close(N(TIF.fused_linear_activation(T(x), T(w), T(b), tx, ty, act)),
           N(JIF.fused_linear_activation(J(x), J(w), J(b), tx, ty, act)))


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu", "geglu"])
@pytest.mark.parametrize("extras", [False, True])
def test_fused_bias_act(act, extras):
    rs = _rs(2)
    x = _f(rs, 2, 4, 8)
    kw = lambda C: dict(bias=C(_rs(3).randn(8).astype(np.float32)),
                        act_method=act)
    if extras:
        xi = _rs(4).randint(-100, 100, (2, 4, 8)).astype(np.int32)
        more = lambda C: dict(dequant_scales=C(np.full(8, 0.01, np.float32)),
                              shift=C(_f(_rs(5), 8)),
                              smooth=C(_f(_rs(6), 8)))
        want = JIF.fused_bias_act(J(xi), **kw(J), **more(J))
        got = TIF.fused_bias_act(T(xi), **kw(T), **more(T))
        assert got.dtype == torch.float16            # after a dequant
        _close(N(got).astype(np.float32), N(want).astype(np.float32), 1e-3)
    else:
        want = JIF.fused_bias_act(J(x), compute_dtype="fp32", **kw(J))
        got = TIF.fused_bias_act(T(x), compute_dtype="fp32", **kw(T))
        _close(N(got), N(want))


def test_fused_bias_act_guards():
    x = torch.randn(2, 8)
    with pytest.raises(NotImplementedError):
        TIF.fused_bias_act(x, quant_scale=1.0)
    with pytest.raises(ValueError):
        TIF.fused_bias_act(x, act_method="tanh")
    with pytest.raises(ValueError):
        TIF.fused_bias_act(x, compute_dtype="int8")


@pytest.mark.parametrize("residual,bias", [(False, False), (True, False),
                                           (True, True)])
def test_fused_layer_norm(residual, bias):
    rs = _rs(8)
    x, r, b = _f(rs, 3, 8), _f(rs, 3, 8), _f(rs, 8)
    g, lb = _f(rs, 8), _f(rs, 8)
    args = lambda C: (C(x), C(g), C(lb), 1e-5, -1,
                      C(b) if bias else None, C(r) if residual else None)
    want, got = JIF.fused_layer_norm(*args(J)), TIF.fused_layer_norm(*args(T))
    if residual:
        _close(N(got[0]), N(want[0]))
        _close(N(got[1]), N(want[1]))
    else:
        _close(N(got), N(want))


def test_fused_bias_dropout_residual_layer_norm():
    rs = _rs(9)
    x, r, b, g, lb = (_f(rs, 2, 3, 8), _f(rs, 2, 3, 8), _f(rs, 8),
                      _f(rs, 8), _f(rs, 8))
    want = JIF.fused_bias_dropout_residual_layer_norm(
        J(x), J(r), J(b), J(g), J(lb), dropout_rate=0.5, training=False)
    got = TIF.fused_bias_dropout_residual_layer_norm(
        T(x), T(r), T(b), T(g), T(lb), dropout_rate=0.5, training=False)
    _close(N(got), N(want))


def test_fused_dropout_add_and_blha():
    x = torch.ones(2, 3)
    np.testing.assert_allclose(
        TIF.fused_dropout_add(x, x, p=0.9, training=False).numpy(), 2.0)
    np.testing.assert_allclose(
        TIF.fused_dropout_add(x, x, p=0.5, training=False,
                              mode="downscale_in_infer").numpy(),
        N(JIF.fused_dropout_add(J(np.ones((2, 3), np.float32)),
                                J(np.ones((2, 3), np.float32)), p=0.5,
                                training=False, mode="downscale_in_infer")))
    big = torch.ones(200, 100)
    a = TIF.fused_dropout_add(big, torch.zeros_like(big), p=0.25, seed=3)
    b = TIF.fused_dropout_add(big, torch.zeros_like(big), p=0.25, seed=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # the seed pins it
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    np.testing.assert_allclose(a[a != 0].numpy(), 1 / 0.75, rtol=1e-6)
    me, md = TIF.blha_get_max_len(torch.tensor([3, 9]), torch.tensor([1, 4]))
    assert me.tolist() == [9] and md.tolist() == [4]


def _fmt_args(C, rs, L=2, H=2, D=4, E=8, F=16, trans=True):
    def per(make):
        return [C(make()) for _ in range(L)]
    return dict(
        ln_scales=per(lambda: _f(rs, E)), ln_biases=per(lambda: _f(rs, E)),
        qkv_weights=per(lambda: _f(rs, *((3, H, D, E) if trans
                                         else (E, 3, H, D)), scale=0.2)),
        qkv_biases=per(lambda: _f(rs, 3, H, D, scale=0.1)),
        linear_weights=per(lambda: _f(rs, H * D, E, scale=0.2)),
        linear_biases=per(lambda: _f(rs, E, scale=0.1)),
        ffn_ln_scales=per(lambda: _f(rs, E)),
        ffn_ln_biases=per(lambda: _f(rs, E)),
        ffn1_weights=per(lambda: _f(rs, E, F, scale=0.2)),
        ffn1_biases=per(lambda: _f(rs, F, scale=0.1)),
        ffn2_weights=per(lambda: _f(rs, F, E, scale=0.2)),
        ffn2_biases=per(lambda: _f(rs, E, scale=0.1)), trans_qkvw=trans)


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("act,alpha,masked", [("gelu", 1.0, False),
                                              ("relu", 0.5, True)])
def test_fused_multi_transformer(trans, act, alpha, masked):
    x = _f(_rs(1), 1, 5, 8)
    mask = _f(_rs(2), 1, 1, 5, 5) if masked else None
    want = JIF.fused_multi_transformer(
        J(x), attn_mask=J(mask), activation=act, residual_alpha=alpha,
        **_fmt_args(J, _rs(3), trans=trans))
    got = TIF.fused_multi_transformer(
        T(x), attn_mask=T(mask), activation=act, residual_alpha=alpha,
        **_fmt_args(T, _rs(3), trans=trans))
    _close(N(got), N(want))


def test_fused_multi_transformer_guards():
    x = torch.randn(1, 5, 8)
    args = _fmt_args(T, _rs(3))
    for kw in (dict(cache_kvs=[1]), dict(pre_caches=[1]),
               dict(rotary_embs=x), dict(time_step=x), dict(seq_lens=x),
               dict(beam_offset=x), dict(pre_layer_norm=False),
               dict(training=True, dropout_rate=0.1)):
        with pytest.raises(NotImplementedError):
            TIF.fused_multi_transformer(x, **args, **kw)
    with pytest.raises(ValueError):
        TIF.fused_multi_transformer(x, **args, activation="tanh")


# -- layers -------------------------------------------------------------------

def test_fused_linear_layer():
    paddle.seed(0)
    for tw in (False, True):
        jl = jinc.nn.FusedLinear(16, 32, transpose_weight=tw)
        tl = tinc.FusedLinear(16, 32, transpose_weight=tw, device="cpu")
        _carry(jl, tl)
        x = _f(_rs(2), 2, 5, 16)
        _close(N(tl(T(x))), N(jl(J(x))))
    assert tinc.FusedLinear(8, 16, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("pre", [False, True])
def test_fused_encoder_layer(pre):
    paddle.seed(1)
    je = jinc.nn.FusedTransformerEncoderLayer(
        d_model=16, nhead=2, dim_feedforward=32, dropout_rate=0.0,
        activation="gelu", normalize_before=pre)
    te = tinc.FusedTransformerEncoderLayer(
        16, 2, 32, dropout_rate=0.0, activation="gelu",
        normalize_before=pre, device="cpu")
    _carry(je, te)
    je.eval()
    te.eval()
    x = _f(_rs(3), 2, 5, 16)
    mask = _f(_rs(4), 2, 1, 5, 5)
    _close(N(te(T(x))), N(je(J(x))))
    _close(N(te(T(x), src_mask=T(mask))), N(je(J(x), src_mask=J(mask))))
    te.train()
    te(T(x)).square().mean().backward()
    assert te.fused_attn.qkv_weight.grad is not None
    assert te.ffn.linear1.weight.grad is not None


def test_bool_attn_mask_and_dropout_layers():
    paddle.seed(5)
    jm = jinc.nn.FusedMultiHeadAttention(16, 2, dropout_rate=0.0,
                                         attn_dropout_rate=0.0)
    tm = tinc.FusedMultiHeadAttention(16, 2, dropout_rate=0.0,
                                      attn_dropout_rate=0.0, device="cpu")
    _carry(jm, tm)
    jm.eval()
    tm.eval()
    x = _f(_rs(6), 2, 5, 16)
    mask = np.ones((2, 1, 5, 5), bool)
    mask[..., 3] = False
    _close(N(tm(T(x), attn_mask=T(mask))),
           N(jm(J(x), attn_mask=paddle.to_tensor(mask))))
    fda = tinc.FusedDropoutAdd(p=0.0)
    np.testing.assert_allclose(fda(torch.ones(2, 3),
                                   torch.full((2, 3), 2.0)).numpy(), 3.0)
    paddle.seed(6)
    jb = jinc.nn.FusedBiasDropoutResidualLayerNorm(16, dropout_rate=0.3)
    tb = tinc.FusedBiasDropoutResidualLayerNorm(16, dropout_rate=0.3,
                                                device="cpu")
    _carry(jb, tb)
    jb.eval()
    tb.eval()
    r = _f(_rs(7), 2, 5, 16)
    _close(N(tb(T(x), T(r))), N(jb(J(x), J(r))))


def test_fused_feedforward_layer_post_ln_uses_norm2():
    paddle.seed(7)
    jf = jinc.nn.FusedFeedForward(16, 32, dropout_rate=0.0,
                                  activation="gelu")
    tf = tinc.FusedFeedForward(16, 32, dropout_rate=0.0, activation="gelu",
                               device="cpu")
    assert tf.norm1 is not tf.norm2
    _carry(jf, tf)
    with torch.no_grad():
        tf.norm2.weight.mul_(2.0)
    jf.norm2.weight._data = jf.norm2.weight._data * 2.0
    x = _f(_rs(8), 2, 5, 16)
    _close(N(tf(T(x))), N(jf(J(x))))


def test_fused_ec_moe_layer():
    paddle.seed(2)
    jm = jinc.nn.FusedEcMoe(16, 32, num_experts=4)
    tm = tinc.FusedEcMoe(16, 32, num_experts=4, device="cpu")
    _carry(jm, tm)
    x = _f(_rs(4), 2, 5, 16)
    _close(N(tm(T(x))), N(jm(J(x))))
    gl = _f(_rs(5), 2, 5, 4)
    _close(N(tm(T(x), T(gl))), N(jm(J(x), J(gl))))


def test_fused_multi_transformer_layer():
    paddle.seed(3)
    jm = jinc.nn.FusedMultiTransformer(embed_dim=16, num_heads=2,
                                       dim_feedforward=32, num_layers=2)
    tm = tinc.FusedMultiTransformer(16, 2, 32, num_layers=2, device="cpu")
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    _carry(jm, tm)
    x = _f(_rs(9), 2, 5, 16)
    _close(N(tm(T(x))), N(jm(J(x))))
    with pytest.raises(NotImplementedError):
        tm(T(x), caches=[1])
    with pytest.raises(NotImplementedError):
        tinc.FusedMultiTransformer(16, 2, 32, normalize_before=False,
                                   device="cpu")

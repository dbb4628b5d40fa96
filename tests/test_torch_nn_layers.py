"""The port's nn pieces of the BERT and GPT families against the JAX
package's: layer_norm, gelu (both forms), tanh, relu, Embedding with
padding_idx, LayerNorm, the initializers, and scaled_dot_product_attention
on its dense path (non-causal, masked, GQA). Dropout draws from torch's
generators, which do not reproduce JAX's bits, so it is held to its own
properties: the identity in eval and at p = 0, the keep rate and scale in
training, and a repeat under the same seed.

Inputs come from numpy seeds. float32 parity is within F32_TOL (different
summation orders); bfloat16 within BF16_TOL, one bf16 rounding (2^-8
relative) of values of order 1, as tests/test_torch_llama.py holds bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn import initializer as PI
from torch_one_thread import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _j(a, dtype=jnp.float32):
    return paddle.Tensor(jnp.asarray(a).astype(dtype))


def _np(t):
    return np.asarray(t._data.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,norm", [((3, 5, 64), 64),
                                        ((2, 4, 6, 8), (6, 8))])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_reference(dtype, shape, norm, affine):
    """Statistics in f32, cast back, then weight and bias in the input
    dtype: the same rounding order, so bf16 agrees to one rounding."""
    jdt, tdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(0)
    x = (3.0 * rs.randn(*shape) + 1.0).astype(np.float32)
    wshape = (norm,) if isinstance(norm, int) else norm
    w = rs.randn(*wshape).astype(np.float32)
    b = rs.randn(*wshape).astype(np.float32)
    want = JF.layer_norm(_j(x, jdt), norm, _j(w, jdt) if affine else None,
                         _j(b, jdt) if affine else None, 1e-5)
    got = PF.layer_norm(torch.as_tensor(x).to(tdt), norm,
                        torch.as_tensor(w).to(tdt) if affine else None,
                        torch.as_tensor(b).to(tdt) if affine else None, 1e-5)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def test_layer_norm_rounds_like_the_reference_not_like_torch():
    """bf16: the reference applies weight and bias after the cast, in bf16;
    torch's layer_norm applies them in f32. The port equals the reference
    bit for bit on this input, where torch's differs in about 30% of the
    elements."""
    rs = np.random.RandomState(1)
    x = rs.randn(64, 128).astype(np.float32)
    w = (1.0 + rs.randn(128)).astype(np.float32)
    b = rs.randn(128).astype(np.float32)
    want = _np(JF.layer_norm(_j(x, jnp.bfloat16), 128, _j(w, jnp.bfloat16),
                             _j(b, jnp.bfloat16), 1e-12))
    xt, wt, bt = (torch.as_tensor(a).bfloat16() for a in (x, w, b))
    got = PF.layer_norm(xt, 128, wt, bt, 1e-12).float().numpy()
    fused = torch.nn.functional.layer_norm(xt, (128,), wt, bt,
                                           1e-12).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert (fused != want).mean() > 0.1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["gelu_erf", "gelu_tanh", "tanh", "relu"])
def test_activations_match_reference(dtype, name):
    jdt, tdt, tol = DTYPES[dtype]
    x = (4.0 * np.random.RandomState(2).randn(4, 33)).astype(np.float32)
    ref_fn, port_fn = {
        "gelu_erf": (lambda a: JF.gelu(a), lambda a: PF.gelu(a)),
        "gelu_tanh": (lambda a: JF.gelu(a, approximate=True),
                      lambda a: PF.gelu(a, approximate=True)),
        "tanh": (JF.tanh, PF.tanh), "relu": (JF.relu, PF.relu)}[name]
    want = _np(ref_fn(_j(x, jdt)))
    got = port_fn(torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_gelu_forms_differ():
    """approximate=True is the tanh form, not the erf form."""
    x = torch.linspace(-3, 3, 61)
    assert not torch.allclose(PF.gelu(x), PF.gelu(x, approximate=True),
                              atol=1e-5)


@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_embedding_matches_reference(padding_idx):
    paddle.seed(0)
    ref = jnn.Embedding(10, 6, padding_idx=padding_idx)
    port = pt.nn.Embedding(10, 6, padding_idx=padding_idx, device="cpu")
    w = np.asarray(ref.weight._data)
    if padding_idx is not None:
        row = padding_idx % 10
        assert not w[row].any()
        assert not port.weight[row].any()
    with torch.no_grad():
        port.weight.copy_(torch.as_tensor(w.copy()))
    ids = np.array([[0, 3, 8, 9], [3, 3, 1, 8]])
    want = np.asarray(ref(paddle.Tensor(jnp.asarray(ids, jnp.int32)))._data)
    got = port(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_array_equal(got, want)


def test_embedding_padding_row_gives_zeros_after_training():
    """A padded lookup is zero even once the row's weight has moved."""
    emb = pt.nn.Embedding(5, 3, padding_idx=1, device="cpu")
    with torch.no_grad():
        emb.weight.fill_(2.0)
    out = emb(torch.tensor([1, 2]))
    assert not out[0].any() and (out[1] == 2.0).all()


@pytest.mark.parametrize("affine", [None, False])
def test_layernorm_layer_matches_reference(affine):
    """LayerNorm: ones weight, zero bias (or none with False), the state's
    keys and shapes as the reference's, outputs equal on carried weights."""
    ref = jnn.LayerNorm(32, 1e-6, weight_attr=affine, bias_attr=affine)
    port = pt.nn.LayerNorm(32, 1e-6, weight_attr=affine, bias_attr=affine,
                           device="cpu")
    ref_state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    assert sorted(port.state_dict()) == sorted(ref_state)
    if affine is None:
        assert torch.equal(port.weight, torch.ones(32))
        assert torch.equal(port.bias, torch.zeros(32))
        rs = np.random.RandomState(3)
        new = {"weight": rs.randn(32), "bias": rs.randn(32)}
        for k, v in new.items():
            getattr(ref, k)._data = jnp.asarray(v, jnp.float32)
        port.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                              for k, v in new.items()})
    x = np.random.RandomState(4).randn(2, 7, 32).astype(np.float32)
    want = np.asarray(ref(_j(x))._data)
    got = port(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_linear_attrs():
    """weight_attr and bias_attr take an initializer; bias_attr=False
    leaves the bias out, as the reference's ParamAttr does."""
    pt.seed(0)
    lin = pt.nn.Linear(8, 4, weight_attr=PI.Constant(0.5),
                       bias_attr=PI.Constant(-1.0), device="cpu")
    assert torch.equal(lin.weight, torch.full((8, 4), 0.5))
    assert torch.equal(lin.bias, torch.full((4,), -1.0))
    assert pt.nn.Linear(8, 4, bias_attr=False, device="cpu").bias is None
    out = lin(torch.ones(2, 8))
    assert torch.equal(out, torch.full((2, 4), 3.0))


def test_truncated_normal():
    """mean + std * z with z in [a, b]; the same draws under the same
    seed; in the layer's dtype."""
    init = PI.TruncatedNormal(mean=1.0, std=0.02)
    gen = torch.Generator().manual_seed(0)
    x = init((200, 500), torch.float32, "cpu", gen)
    assert x.min() >= 1.0 - 0.04 and x.max() <= 1.0 + 0.04
    # a normal truncated at 2 sigma has std 0.8796 sigma
    assert abs(x.std().item() / 0.02 - 0.8796) < 0.01
    assert abs(x.mean().item() - 1.0) < 1e-3
    again = init((200, 500), torch.float32, "cpu",
                 torch.Generator().manual_seed(0))
    assert torch.equal(x, again)
    assert init((3,), torch.bfloat16, "cpu", gen).dtype == torch.bfloat16


def test_layer_list_is_module_list():
    layers = pt.nn.LayerList([pt.nn.Dropout(0.1), pt.nn.Dropout(0.2)])
    assert isinstance(layers, torch.nn.ModuleList) and len(layers) == 2


# -- dropout: its own properties ---------------------------------------------

def test_dropout_identity_in_eval_and_at_p0():
    x = torch.randn(4, 8)
    layer = pt.nn.Dropout(0.5).eval()
    assert layer(x) is x
    assert PF.dropout(x, 0.0, training=True) is x
    assert PF.dropout(x, 0.3, training=False) is x


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_keep_rate_and_scale(mode):
    """About 1 - p of the elements kept (within 6 sigma of a binomial), the
    kept ones scaled by 1 / (1 - p) in upscale_in_train, as they are in
    downscale_in_infer, the rest zero."""
    pt.seed(0)
    p, n = 0.3, 200_000
    x = torch.full((n,), 2.0)
    out = PF.dropout(x, p, training=True, mode=mode)
    kept = out != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 6 * (p * (1 - p) / n) ** 0.5
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 2 * scale))


def test_dropout_repeats_under_the_same_seed():
    x = torch.randn(64, 64)
    pt.seed(7)
    a = PF.dropout(x, 0.5)
    b = PF.dropout(x, 0.5)
    pt.seed(7)
    assert torch.equal(PF.dropout(x, 0.5), a)
    assert not torch.equal(a, b)       # the generator moved on


def test_dropout_axis_draws_one_mask_over_the_axis():
    """axis=1 draws one keep per column, broadcast over the rows."""
    pt.seed(1)
    out = PF.dropout(torch.ones(50, 40), 0.5, axis=1)
    assert (out == out[:1]).all()
    assert 0 < (out[0] == 0).sum() < 40


def test_dropout_layer_follows_training_flag():
    pt.seed(2)
    layer = pt.nn.Dropout(0.5)
    x = torch.ones(1000)
    assert (layer(x) == 0).any()
    layer.eval()
    assert torch.equal(layer(x), x)


# -- attention on the dense path ---------------------------------------------

@pytest.mark.parametrize("case", ["noncausal", "causal", "masked",
                                  "masked_causal", "gqa_noncausal"])
def test_sdpa_dense_matches_reference(case):
    """Non-causal (BERT's call), causal, an additive mask (BERT's 2-D mask
    made additive), and GQA; CPU tensors take the dense math."""
    rs = np.random.RandomState(5)
    kvh = 2 if case.startswith("gqa") else 4
    q = rs.randn(2, 24, 4, 16).astype(np.float32)
    k, v = (rs.randn(2, 24, kvh, 16).astype(np.float32) for _ in range(2))
    bias = None
    if case.startswith("masked"):
        keep = rs.rand(2, 1, 1, 24) > 0.3
        bias = np.where(keep, 0.0, -1e30).astype(np.float32)
    causal = case in ("causal", "masked_causal")
    want = JF.scaled_dot_product_attention(
        _j(q), _j(k), _j(v), attn_mask=None if bias is None else _j(bias),
        is_causal=causal, training=False)
    got = PF.scaled_dot_product_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        attn_mask=None if bias is None else torch.as_tensor(bias),
        is_causal=causal, training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=F32_TOL, atol=F32_TOL)


def test_sdpa_dropout_in_training():
    """dropout_p > 0 in training drops probabilities from the port's
    generator: a repeat under the same seed is equal, another draw
    differs, and outside training (or at p = 0) it is the dropout-free
    attention. With p -> its expectation: averaged over many draws the
    output approaches the dropout-free one."""
    rs = np.random.RandomState(6)
    q, k, v = (torch.as_tensor(rs.randn(1, 16, 2, 8).astype(np.float32))
               for _ in range(3))
    plain = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert torch.equal(PF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, is_causal=True, training=False), plain)
    pt.seed(3)
    a = PF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                        is_causal=True)
    b = PF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                        is_causal=True)
    pt.seed(3)
    assert torch.equal(PF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, is_causal=True), a)
    assert not torch.equal(a, b) and not torch.allclose(a, plain)
    mean = torch.stack([PF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, is_causal=True) for _ in range(2000)]).mean(0)
    assert (mean - plain).abs().max() < 0.1


def test_flash_attention_wraps_sdpa():
    rs = np.random.RandomState(7)
    q, k, v = (torch.as_tensor(rs.randn(2, 12, 2, 8).astype(np.float32))
               for _ in range(3))
    out, softmax = PF.flash_attention(q, k, v, causal=True)
    assert softmax is None
    assert torch.equal(out, PF.scaled_dot_product_attention(
        q, k, v, is_causal=True))

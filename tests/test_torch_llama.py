"""The port's Llama (and its functionals) against the JAX package's, with
the reference's weights carried across by paddle_tpu_torch.convert.

Everything runs in float32 on the CPU; inputs are made with numpy from a
seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel.functional import \
    split_stacked_layer_params as jax_split
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_reference_state, \
    state_from_reference
from paddle_tpu_torch.incubate.nn import functional as PIF
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.parallel.functional import split_stacked_layer_params

TOL = 1e-4   # fp32, different summation orders

CONFIGS = {
    "mha": dict(num_key_value_heads=4),
    "gqa": dict(num_key_value_heads=2),
    "tied": dict(num_key_value_heads=2, tie_word_embeddings=True),
    "untied_mha": dict(num_key_value_heads=4, tie_word_embeddings=False),
}


def _np_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _pair(seed=0, **kw):
    paddle.seed(seed)
    ref = paddle.models.llama_tiny(**kw)
    port = pt.models.llama_tiny(device="cpu", **kw)
    load_reference_state(port, _np_state(ref))
    return ref, port


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_reference(name):
    ref, port = _pair(**CONFIGS[name])
    ids = np.random.RandomState(0).randint(0, 512, (2, 11))
    want = np.asarray(ref(paddle.Tensor(jnp.asarray(ids, jnp.int32)))._data)
    with torch.no_grad():
        got = port(torch.as_tensor(ids)).numpy()
    assert got.shape == (2, 11, 512)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_keys_and_shapes_match_reference(name):
    paddle.seed(0)
    ref = _np_state(paddle.models.llama_tiny(**CONFIGS[name]))
    port = pt.models.llama_tiny(device="cpu", **CONFIGS[name]).state_dict()
    assert list(port) == list(ref)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}


def test_position_ids_match_reference():
    ref, port = _pair(num_key_value_heads=2)
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 512, (2, 9))
    pos = np.stack([np.arange(9), np.arange(9)[::-1]])
    want = np.asarray(ref(paddle.Tensor(jnp.asarray(ids, jnp.int32)),
                          paddle.Tensor(jnp.asarray(pos, jnp.int32)))._data)
    with torch.no_grad():
        got = port(torch.as_tensor(ids), torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_state_from_reference_builds_the_port_state():
    paddle.seed(2)
    np_state = _np_state(paddle.models.llama_tiny())
    state = state_from_reference(np_state, "cpu", dtype="bfloat16")
    assert list(state) == list(np_state)
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    port = pt.models.llama_tiny(device="cpu", dtype="bfloat16")
    port.load_state_dict(state)
    w = "llama.layers.1.mlp.down_proj.weight"
    np.testing.assert_allclose(port.state_dict()[w].float().numpy(),
                               np_state[w], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
@pytest.mark.parametrize("fn", ["load", "state"])
def test_converter_rejects_bad_state(fault, fn):
    paddle.seed(0)
    np_state = _np_state(paddle.models.llama_tiny())
    if fault == "missing":
        del np_state["llama.layers.1.self_attn.v_proj.weight"]
    elif fault == "unexpected":
        np_state["llama.layers.0.self_attn.q_proj.bias"] = np.zeros(128)
    else:
        np_state["llama.layers.0.mlp.up_proj.weight"] = np.zeros((128, 255))
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err):
        if fn == "load":
            load_reference_state(pt.models.llama_tiny(device="cpu"), np_state)
        else:
            state_from_reference(np_state, "cpu")


def test_split_stacked_layer_params_matches_reference():
    paddle.seed(0)
    np_state = _np_state(paddle.models.llama_tiny(num_hidden_layers=3))
    ref_stacked, ref_other = jax_split(
        {k: jnp.asarray(v) for k, v in np_state.items()})
    stacked, other = split_stacked_layer_params(
        {k: torch.tensor(v) for k, v in np_state.items()})
    assert set(stacked) == set(ref_stacked) and set(other) == set(ref_other)
    for k, v in stacked.items():
        assert v.shape[0] == 3
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_stacked[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rs = np.random.RandomState(6)
    x, w = rs.randn(3, 5, 64).astype(np.float32), rs.randn(64).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JF.rms_norm(paddle.Tensor(jnp.asarray(x).astype(jdt)),
                       paddle.Tensor(jnp.asarray(w).astype(jdt)), 1e-5)
    got = PF.rms_norm(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                      1e-5)
    assert got.dtype == tdt
    # bf16: identical rounding order, so equal up to one bf16 rounding
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._data.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_v", [False, True])
@pytest.mark.parametrize("with_pos", [False, True])
def test_rotary_embedding_matches_reference(with_v, with_pos):
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(2, 6, 4, 16).astype(np.float32),
               rs.randn(2, 6, 2, 16).astype(np.float32),
               rs.randn(2, 6, 2, 16).astype(np.float32))
    pos = rs.randint(0, 6, (2, 6)) if with_pos else None
    v = v if with_v else None
    want = JIF.fused_rotary_position_embedding(
        paddle.Tensor(jnp.asarray(q)), paddle.Tensor(jnp.asarray(k)),
        None if v is None else paddle.Tensor(jnp.asarray(v)),
        position_ids=None if pos is None else paddle.Tensor(
            jnp.asarray(pos, jnp.int32)))
    got = PIF.fused_rotary_position_embedding(
        torch.as_tensor(q), torch.as_tensor(k),
        None if v is None else torch.as_tensor(v),
        position_ids=None if pos is None else torch.as_tensor(pos))
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [False, True])
def test_swiglu_matches_reference(split):
    rs = np.random.RandomState(8)
    x, y = rs.randn(3, 32).astype(np.float32), rs.randn(3, 32).astype(
        np.float32)
    if split:
        want = JIF.swiglu(paddle.Tensor(jnp.asarray(x)))
        got = PIF.swiglu(torch.as_tensor(x))
    else:
        want = JIF.swiglu(paddle.Tensor(jnp.asarray(x)),
                          paddle.Tensor(jnp.asarray(y)))
        got = PIF.swiglu(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)


def test_initializers_follow_reference_defaults():
    """Xavier-uniform Linear weights within the reference's limit, zero
    bias, ones RMSNorm, N(0, 1) embedding."""
    pt.seed(0)
    lin = pt.nn.Linear(64, 192, device="cpu")
    limit = (6.0 / (64 + 192)) ** 0.5
    assert lin.weight.shape == (64, 192)
    assert lin.weight.abs().max() <= limit and lin.weight.std() > limit / 3
    assert torch.count_nonzero(lin.bias) == 0
    assert torch.equal(pt.nn.RMSNorm(8, device="cpu").weight, torch.ones(8))
    emb = pt.nn.Embedding(1000, 64, device="cpu").weight
    assert abs(emb.mean().item()) < 0.05 and abs(emb.std().item() - 1) < 0.05
    pt.seed(0)
    again = pt.nn.Linear(64, 192, device="cpu")
    assert torch.equal(again.weight, lin.weight)

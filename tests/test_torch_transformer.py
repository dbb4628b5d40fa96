"""The port's Transformer layers (nn/layer/transformer.py) against the
reference's (paddle_tpu/nn/layer/transformer.py), with the reference's
weights (drawn from numpy) copied in: MultiHeadAttention with an
additive mask and with a cache, pre- and post-norm encoder and decoder
layers, the stacks and Transformer with generate_square_subsequent_mask,
outputs and every parameter's gradient (the reference's through its
jitted functional_call). Dropout is off (eval mode, or p = 0). float32 at
rtol 1e-5, atol 1e-5 (gradients 2e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor as RefTensor
import paddle_tpu_torch as pt
from torch_seq_parity import assert_grads_close, copy_weights, ref_np, \
    ref_run, reference
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(0)
B, S, D, H, FF = 2, 5, 8, 2, 16
SRC = RNG.standard_normal((B, S, D)).astype(np.float32)
TGT = RNG.standard_normal((B, S - 1, D)).astype(np.float32)
W = RNG.standard_normal((B, S, D)).astype(np.float32)


def _both(name, *args, **kw):
    ref = reference(lambda: getattr(paddle.nn, name)(*args, **kw))
    port = getattr(pt.nn, name)(*args, **kw, device="cpu")
    return copy_weights(port, ref), ref


def _loss(out):
    """sum(W * out), the gradients' loss, on either package's output."""
    w = W[:, :out.shape[1]]
    if isinstance(out, torch.Tensor):
        return (out * torch.tensor(w)).sum()
    return (out * w).sum()


def test_mha_with_mask_and_grads():
    port, ref = _both("MultiHeadAttention", D, H)
    mask = np.where(RNG.random((B, 1, S - 1, S)) > 0.3, 0.0,
                    -1e9).astype(np.float32)
    outp = port(*(torch.tensor(a) for a in (TGT, SRC, SRC, mask)))
    outr, grads = ref_run(ref, lambda f: f(TGT, SRC, SRC, mask), _loss)
    np.testing.assert_allclose(outp.detach().numpy(), outr, **TOL)
    _loss(outp).backward()
    assert_grads_close(port, grads, **GTOL)


def test_mha_cache_and_kdim():
    port, ref = _both("MultiHeadAttention", D, H, 0.0, 6, 6)
    kv = RNG.standard_normal((B, 3, 6)).astype(np.float32)
    for cache in (port.gen_cache(torch.tensor(kv)),
                  ref.gen_cache(paddle.to_tensor(kv))):
        assert tuple(cache[0].shape) == (B, 0, H, D // H)

    def steps(call, cache):
        outs = []
        for t in range(3):
            out, cache = call(TGT[:, t:t + 1], kv[:, t:t + 1],
                              kv[:, t:t + 1], None, cache)
            outs.append(out)
        return outs, cache

    outp, cachep = steps(
        lambda q, k, v, mask, cache: port(
            torch.tensor(q), torch.tensor(k), torch.tensor(v), mask, cache),
        port.gen_cache(torch.tensor(kv)))
    (outr, cacher), _ = ref_run(ref, lambda f: steps(
        f, ref.gen_cache(RefTensor(jnp.asarray(kv)))))
    for a, b in zip(outp, outr):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)
    for a, b in zip(cachep, cacher):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)
        assert a.shape[1] == 3


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("kind", ["Encoder", "Decoder"])
def test_layers(kind, normalize_before):
    port, ref = _both(f"Transformer{kind}Layer", D, H, FF, 0.0, "relu",
                      normalize_before=normalize_before)
    args = ((SRC,) if kind == "Encoder" else
            (TGT, SRC, np.triu(np.full((S - 1, S - 1), -1e9, np.float32),
                               1)))
    outp = port(*(torch.tensor(a) for a in args))
    outr, grads = ref_run(ref, lambda f: f(*args), _loss)
    np.testing.assert_allclose(outp.detach().numpy(), outr, **TOL)
    _loss(outp).backward()
    assert_grads_close(port, grads, **GTOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_and_mask(normalize_before):
    port, ref = _both("Transformer", D, H, 2, 2, FF, 0.1, "gelu",
                      normalize_before=normalize_before)
    port.eval()
    ref.eval()
    assert list(port.state_dict()) == list(ref.state_dict())
    mp = port.generate_square_subsequent_mask(S - 1)
    mr = ref.generate_square_subsequent_mask(S - 1)
    np.testing.assert_array_equal(mp.numpy(), ref_np(mr))
    outp = port(torch.tensor(SRC), torch.tensor(TGT), tgt_mask=mp)
    outr, grads = ref_run(ref, lambda f: f(SRC, TGT, tgt_mask=ref_np(mr)),
                          _loss, training=False)
    np.testing.assert_allclose(outp.detach().numpy(), outr, **TOL)
    _loss(outp).backward()
    assert_grads_close(port, grads, **GTOL)


def test_stack_layers_start_equal():
    layer = pt.nn.TransformerEncoderLayer(D, H, FF, device="cpu")
    enc = pt.nn.TransformerEncoder(layer, 3)
    w = [lay.linear1.weight for lay in enc.layers]
    assert w[0] is layer.linear1.weight and w[1] is not w[0]
    torch.testing.assert_close(w[1], w[0], rtol=0, atol=0)


def test_training_dropout_draws_from_the_port_generator():
    port = pt.nn.TransformerEncoderLayer(D, H, FF, 0.5, device="cpu")
    x = torch.tensor(SRC)
    pt.seed(1)
    a = port(x)
    pt.seed(1)
    b = port(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, port.eval()(x))

"""The port's recurrent layers (nn/layer/rnn.py) against the reference's
(paddle_tpu/nn/layer/rnn.py), with the reference's weights (drawn from
numpy) copied in: the cells, RNN, BiRNN and multi-layer, bidirectional
SimpleRNN/GRU/LSTM, outputs, final states and every parameter's
gradient (the reference's through its jitted functional_call). float32
at rtol 1e-5, atol 1e-5; a bf16 cell on float32 default states at the
bf16 tolerance rtol 2e-2, atol 2e-2. The input width is twice the hidden
width, the width a bidirectional layer's second layer takes."""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_seq_parity import assert_grads_close, copy_weights, nest_map, \
    ref_np, ref_run, reference
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)
B, T, HID = 2, 4, 4
IN = 2 * HID
XS = RNG.standard_normal((B, T, IN)).astype(np.float32)
H0 = RNG.standard_normal((B, HID)).astype(np.float32)
C0 = RNG.standard_normal((B, HID)).astype(np.float32)
W = RNG.standard_normal((B, T, 2 * HID)).astype(np.float32)


def _both(name, *args, **kw):
    ref = reference(lambda: getattr(paddle.nn, name)(*args, **kw))
    port = getattr(pt.nn, name)(*args, **kw, device="cpu")
    return copy_weights(port, ref), ref


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _close(p, r, **tol):
    pf, rf = _flat(p), _flat(r)
    assert len(pf) == len(rf)
    for a, b in zip(pf, rf):
        assert tuple(a.shape) == tuple(np.shape(ref_np(b)))
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   ref_np(b).astype(np.float32), **tol)


@pytest.mark.parametrize("name,kw", [
    ("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
    ("GRUCell", {}), ("LSTMCell", {})])
def test_cell_step_and_grads(name, kw):
    port, ref = _both(name, IN, HID, **kw)
    lstm = name == "LSTMCell"
    x = XS[:, 0]
    s0 = (H0, C0) if lstm else H0
    w = W[:, 0, :HID]
    # with given states, and with the default (zero) states
    outr, grads = ref_run(ref, lambda f: (f(x, s0), f(x)),
                          loss=lambda o: (o[0][0] * w).sum())
    outp = port(torch.tensor(x), nest_map(torch.tensor, s0))
    _close(outp, outr[0], **TOL)
    _close(port(torch.tensor(x)), outr[1], **TOL)
    (outp[0] * torch.tensor(w)).sum().backward()
    assert_grads_close(port, grads, **TOL)


@pytest.mark.parametrize("name", ["GRUCell", "LSTMCell"])
def test_bf16_cell_on_float32_default_states(name):
    port, ref = _both(name, IN, HID)
    port.astype("bfloat16")
    ref.to(dtype="bfloat16")
    xp = torch.tensor(XS[:, 0]).bfloat16()
    xr = paddle.to_tensor(XS[:, 0]).astype("bfloat16")
    outp, outr = port(xp), ref(xr)
    assert outp[0].dtype == torch.float32
    assert ref_np(outr[0]).dtype == np.float32
    _close(outp, outr, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("wrapper", ["RNN", "RNN_reverse", "BiRNN"])
def test_rnn_wrappers(wrapper, time_major):
    ref_cells = [reference(lambda: paddle.nn.LSTMCell(IN, HID)),
                 reference(lambda: paddle.nn.GRUCell(IN, HID), 1)]
    port_cells = [copy_weights(pt.nn.LSTMCell(IN, HID, device="cpu"), c)
                  if i == 0 else copy_weights(
                      pt.nn.GRUCell(IN, HID, device="cpu"), c)
                  for i, c in enumerate(ref_cells)]
    if wrapper == "BiRNN":
        ref = paddle.nn.BiRNN(*ref_cells, time_major=time_major)
        port = pt.nn.BiRNN(*port_cells, time_major=time_major)
    else:
        rev = wrapper == "RNN_reverse"
        ref = paddle.nn.RNN(ref_cells[0], rev, time_major)
        port = pt.nn.RNN(port_cells[0], rev, time_major)
    assert list(port.state_dict()) == list(ref.state_dict())
    x = XS.transpose(1, 0, 2) if time_major else XS
    outp = port(torch.tensor(x))
    w = W[..., :outp[0].shape[-1]]
    w = w.transpose(1, 0, 2) if time_major else w
    outr, grads = ref_run(ref, lambda f: f(x),
                          loss=lambda o: (o[0] * w).sum())
    _close(outp, outr, **TOL)
    (outp[0] * torch.tensor(w)).sum().backward()
    assert_grads_close(port, grads, **TOL)


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("name", ["SimpleRNN", "GRU", "LSTM"])
def test_multi_layer(name, direction):
    port, ref = _both(name, IN, HID, 2, direction)
    assert list(port.state_dict()) == list(ref.state_dict())
    outp = port(torch.tensor(XS))
    w = W[..., :outp[0].shape[-1]]
    outr, grads = ref_run(
        ref, lambda f: f(XS),
        loss=lambda o: (o[0] * w).sum() + jax.tree_util.tree_leaves(
            o[1])[0].sum())
    _close(outp, outr, **TOL)
    loss_p = (outp[0] * torch.tensor(w)).sum() + _flat(outp[1])[0].sum()
    loss_p.backward()
    assert_grads_close(port, grads, **TOL)


def test_time_major_layer():
    port, ref = _both("LSTM", IN, HID, 1, "forward", True)
    x = XS.transpose(1, 0, 2)
    _close(port(torch.tensor(x)), ref(paddle.to_tensor(x)), **TOL)


def test_initial_states_are_ignored_as_in_the_reference():
    """`_RNNBase.forward` starts from zeros (rnn.py:221-222)."""
    port = pt.nn.GRU(IN, HID, device="cpu")
    h = torch.randn(1, B, HID)
    torch.testing.assert_close(port(torch.tensor(XS), h)[0],
                               port(torch.tensor(XS))[0])

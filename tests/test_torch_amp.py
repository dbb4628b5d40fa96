"""The port's amp against the JAX package's.

- O1: the cast table (each hooked op's name and the dtypes of its inputs
  after the cast) of one training forward of a small conv + batch norm +
  linear + cross-entropy net under `auto_cast`, against the reference's
  operator observer on the same net (filtered to the ops its white and
  black lists name): convolutions and the linear in bfloat16, the batch
  norm and cross_entropy in float32. The loss, and every float32
  parameter's gradient, agree within BF16_TOL of the largest |value|
  (the net's largest |gradient| for the gradients): a bf16 rounding or
  two of values of order 1. Custom white and black
  lists move an op across, and the lists themselves equal the
  reference's. Each other hooked functional (linear, matmul, bmm,
  einsum, the dense attention, fused_matmul_bias: white; softmax,
  log_softmax, layer_norm, rms_norm on bf16 input: black) gives the
  reference's output dtype under O1 and its value within BF16_TOL.
- O2: `decorate` casts every float32 parameter to bfloat16 in place,
  batch norm and LayerNorm excepted, keeping each parameter's identity.
- GradScaler: the reference's dynamics over a run of finite steps and an
  injected inf (the step is skipped, the scale falls by decr_ratio), and
  its state_dict round-trips.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import core as jcore
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.nn import functional as PF
from torch_one_thread import one_torch_thread  # noqa: F401

BF16_TOL = 2e-2
LISTED = jamp.WHITE_LIST | jamp.BLACK_LIST


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(3, 4, 3, padding=1)
        self.bn = jnn.BatchNorm2D(4)
        self.fc = jnn.Linear(4 * 6 * 6, 5)

    def forward(self, x):
        h = JF.relu(self.bn(self.conv(x)))
        return self.fc(h.reshape([h.shape[0], -1]))


class PNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = pnn.Conv2D(3, 4, 3, padding=1, device="cpu")
        self.bn = pnn.BatchNorm2D(4, device="cpu")
        self.fc = pnn.Linear(4 * 6 * 6, 5, device="cpu")

    def forward(self, x):
        h = torch.relu(self.bn(self.conv(x)))
        return self.fc(h.reshape(h.shape[0], -1))


def _nets():
    ref, port = JNet(), PNet()
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    return ref, port


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 3, 6, 6).astype(np.float32),
            rng.randint(0, 5, (4,)).astype(np.int64))


def _dtype_name(dt):
    """float dtypes by name; integers as "int" (JAX's labels are int32
    where torch's are int64)."""
    name = str(dt).replace("torch.", "")
    return "int" if name.startswith(("int", "uint")) else name


def _record(install):
    table = []
    install(lambda name, arrs: table.append(
        (name, tuple(_dtype_name(a.dtype) for a in arrs))))
    return table


def test_o1_cast_table_loss_and_grads_match_reference():
    ref, port = _nets()
    x, y = _batch()
    ref_table = _record(lambda f: setattr(jcore, "_op_observer_hook", f))
    try:
        with jamp.auto_cast(level="O1"):
            jloss = JF.cross_entropy(ref(paddle.to_tensor(x)),
                                     paddle.to_tensor(y))
    finally:
        jcore._op_observer_hook = None
    jloss.backward()
    port_table = _record(lambda f: setattr(pamp, "_op_observer", f))
    try:
        with pamp.auto_cast(level="O1"):
            tloss = PF.cross_entropy(port(torch.tensor(x)), torch.tensor(y))
    finally:
        pamp._op_observer = None
    tloss.backward()
    ref_table = [r for r in ref_table if r[0] in LISTED]
    assert port_table == ref_table
    assert port_table == [
        ("conv2d", ("bfloat16",) * 3), ("batch_norm", ("float32",) * 3),
        ("linear", ("bfloat16",) * 3), ("cross_entropy", ("float32", "int"))]
    assert tloss.dtype == torch.float32
    want = float(np.asarray(jloss._data))
    assert abs(float(tloss) - want) <= BF16_TOL * abs(want)
    # each gradient within BF16_TOL of the largest |gradient| of the net:
    # the conv bias before a training-mode batch norm has gradient 0 up to
    # rounding, so its own largest |value| is no scale
    ref_grads = {n: np.asarray(p.grad._data, np.float32)
                 for n, p in ref.named_parameters()}
    scale = max(np.abs(g).max() for g in ref_grads.values())
    for name, p in port.named_parameters():
        assert p.grad.dtype == torch.float32, name
        err = np.abs(p.grad.numpy() - ref_grads[name]).max() / scale
        assert err <= BF16_TOL, (name, err)


def test_custom_lists_and_the_lists_themselves():
    assert pamp.WHITE_LIST == jamp.WHITE_LIST
    assert pamp.BLACK_LIST == jamp.BLACK_LIST
    assert pamp.white_list()["bfloat16"]["O1"] == jamp.WHITE_LIST
    assert pamp.black_list()["float16"]["O2"] == jamp.BLACK_LIST
    x = torch.randn(3, 4)
    w = torch.randn(4, 2)
    with pamp.auto_cast(custom_black_list={"linear"}):
        assert PF.linear(x, w).dtype == torch.float32
        assert PF.softmax(x.bfloat16()).dtype == torch.float32
    with pamp.auto_cast(custom_white_list={"mse_loss"}, dtype="float16"):
        assert PF.mse_loss(x, x).dtype == torch.float16
        assert PF.linear(x, w).dtype == torch.float16
    with pamp.auto_cast(enable=False):
        assert PF.linear(x, w).dtype == torch.float32
    assert PF.linear(x, w).dtype == torch.float32      # outside: no cast
    assert pamp.amp_guard is pamp.auto_cast
    assert pamp.is_bfloat16_supported() and pamp.is_float16_supported()


def test_o2_decorate_casts_in_place_but_norms():
    ref, port = _nets()
    ln = pnn.LayerNorm(5, device="cpu")
    port.ln = ln
    params = list(port.parameters())
    opt = popt.Momentum(0.1, parameters=params)
    out = pamp.decorate(port, opt, level="O2")
    assert out[0] is port and out[1] is opt
    jamp.decorate(ref, level="O2")
    for (name, p), q in zip(port.named_parameters(), params):
        assert p is q
        want = "float32" if name.startswith(("bn.", "ln.")) else "bfloat16"
        assert _dtype_name(p.dtype) == want, name
        if not name.startswith("ln."):
            assert str(dict(ref.named_parameters())[name]._data.dtype) \
                == want, name
    x, y = _batch()
    with pamp.auto_cast(level="O2"):
        loss = PF.cross_entropy(port(torch.tensor(x)), torch.tensor(y))
    loss.backward()
    opt.step()
    assert torch.isfinite(loss) and port.fc.weight.dtype == torch.bfloat16
    assert pamp.amp_decorate(port, level="O1") is port


def _scaler_run(mk_scaler, mk_param, set_grad, step_inf):
    """Six steps of SGD through a scaler at incr_every_n_steps 2, the
    fourth with an inf in a gradient; the scale, the good/bad counts and
    the parameter after each."""
    p = mk_param()
    opt = step_inf[0](p)
    sc = mk_scaler()
    trace = []
    for i in range(6):
        set_grad(p, i == 3, sc._scale)
        sc.step(opt)
        trace.append((sc._scale, sc._good_steps, sc._bad_steps,
                      step_inf[1](p)))
    return trace, sc


def test_grad_scaler_dynamics_match_reference():
    kw = dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    g = np.array([0.5, -1.0, 2.0], np.float32)

    def jgrad(p, inf, scale):
        a = g * scale
        if inf:
            a = a.copy()
            a[1] = np.inf
        p.grad = jcore.Tensor(jnp.asarray(a))

    def tgrad(p, inf, scale):
        a = torch.tensor(g * scale)
        if inf:
            a[1] = float("inf")
        p.grad = a

    jtrace, _ = _scaler_run(
        lambda: jamp.GradScaler(**kw),
        lambda: jcore.Parameter(jnp.ones(3, jnp.float32)), jgrad,
        (lambda p: jopt.SGD(0.1, parameters=[p]),
         lambda p: np.asarray(p._data).copy()))
    ttrace, sc = _scaler_run(
        lambda: pamp.GradScaler(**kw),
        lambda: torch.nn.Parameter(torch.ones(3)), tgrad,
        (lambda p: popt.SGD(0.1, parameters=[p]),
         lambda p: p.detach().numpy().copy()))
    for (js, jg, jb, jp), (ts, tg, tb, tp) in zip(jtrace, ttrace):
        assert (js, jg, jb) == (ts, tg, tb)
        np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    # the inf step was skipped and the scale fell by decr_ratio
    np.testing.assert_array_equal(ttrace[3][3], ttrace[2][3])
    assert ttrace[3][0] == ttrace[2][0] * 0.5
    sd = sc.state_dict()
    sc2 = pamp.GradScaler()
    sc2.load_state_dict(sd)
    assert sc2.state_dict() == sd
    assert float(sc2.get_loss_scaling()) == sd["scale"]
    off = pamp.GradScaler(enable=False)
    x = torch.ones(2)
    assert off.scale(x) is x and not off.is_enable()
    assert pamp.GradScaler().is_use_dynamic_loss_scaling()


def test_grad_scaler_minimize_takes_the_caller_backward():
    p = torch.nn.Parameter(torch.ones(3))
    opt = popt.SGD(0.5, parameters=[p])
    sc = pamp.GradScaler(init_loss_scaling=8.0)
    sc.scale((p * 2).sum()).backward()
    sc.minimize(opt, None)
    np.testing.assert_allclose(p.detach().numpy(), [0.0] * 3)


def _t(m):
    """The package's tensor functions: the reference exports them at its
    top level, the port in `tensor`."""
    return m if m is paddle else m.tensor


# each hooked functional under O1 against the reference's under O1: the
# output's dtype, and its value within BF16_TOL of the largest |value|
_R = np.random.RandomState(4)
_X, _W = _R.randn(4, 8).astype(np.float32), _R.randn(8, 6).astype(np.float32)
_B3 = _R.randn(2, 4, 8).astype(np.float32)
_Q = _R.randn(2, 5, 2, 8).astype(np.float32)
HOOKED = {
    "linear": (lambda M, P: M.nn.functional.linear(P(_X), P(_W)), True),
    "matmul": (lambda M, P: _t(M).matmul(P(_X), P(_W.T), transpose_y=True),
               True),
    "bmm": (lambda M, P: _t(M).bmm(P(_B3), P(_B3.transpose(0, 2, 1))),
            True),
    "einsum": (lambda M, P: _t(M).einsum("ij,jk->ik", P(_X), P(_W)), True),
    "sdpa": (lambda M, P: M.nn.functional.scaled_dot_product_attention(
        P(_Q), P(_Q), P(_Q)), True),
    "softmax": (lambda M, P: M.nn.functional.softmax(P(_X).astype(
        "bfloat16") if M is paddle else P(_X).bfloat16()), False),
    "log_softmax": (lambda M, P: M.nn.functional.log_softmax(
        P(_X).astype("bfloat16") if M is paddle else P(_X).bfloat16()),
        False),
    "layer_norm": (lambda M, P: M.nn.functional.layer_norm(
        P(_X).astype("bfloat16") if M is paddle else P(_X).bfloat16(), 8),
        False),
    "rms_norm": (lambda M, P: M.nn.functional.rms_norm(
        P(_X).astype("bfloat16") if M is paddle else P(_X).bfloat16()),
        False),
    "fused_matmul_bias": (lambda M, P: M.incubate.nn.functional
                          .fused_matmul_bias(P(_X), P(_W), P(_W[0])), True),
}


@pytest.mark.parametrize("name", sorted(HOOKED))
def test_each_hooked_functional_casts_as_the_reference(name):
    import paddle_tpu_torch.incubate  # noqa: F401
    fn, white = HOOKED[name]
    with jamp.auto_cast(level="O1"):
        want = fn(paddle, paddle.to_tensor)
    with pamp.auto_cast(level="O1"):
        got = fn(pt, torch.tensor)
    assert _dtype_name(got.dtype) == str(want._data.dtype) == (
        "bfloat16" if white else "float32")
    w = np.asarray(want._data.astype(jnp.float32))
    err = np.abs(got.float().numpy() - w).max() / np.abs(w).max()
    assert err <= BF16_TOL, err

"""The port's initializers (nn/initializer.py) against the reference's
(paddle_tpu/nn/initializer/__init__.py). The deterministic ones (Constant,
Assign, Dirac, Bilinear, calculate_gain) must be equal exactly. The random
ones cannot draw the reference's bits (torch's generators, not JAX keys):
each is held to the bound or standard deviation the reference's fans and
gains give (sample moments within 3% on 65,536 draws, bounds exact), and
to the reference's own sample standard deviation within 5%."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.nn import initializer as RI
from paddle_tpu_torch.nn import initializer as PI

SHAPES = [(256, 256), (16, 4, 32, 32)]


def _draw(init, shape):
    return init(shape, torch.float32, "cpu",
                torch.Generator().manual_seed(0)).numpy()


def _ref_draw(init, shape):
    return np.asarray(init._init(shape, np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "conv"])
@pytest.mark.parametrize("name,args,kind", [
    ("XavierUniform", (), "uniform"),
    ("XavierNormal", (), "normal"),
    ("XavierUniform", (100, 50, 0.5), "uniform"),
    ("KaimingUniform", (), "uniform"),
    ("KaimingNormal", (), "normal"),
    ("KaimingNormal", (None, 0.2, "leaky_relu"), "normal"),
    ("KaimingUniform", (30, 0.0, "tanh"), "uniform"),
    ("Uniform", (-0.3, 0.3), "uniform"),
    ("Normal", (0.0, 0.7), "normal"),
    ("TruncatedNormal", (0.0, 1.0), "truncated"),
])
def test_random_initializers_by_moments(name, args, kind, shape):
    port = _draw(getattr(PI, name)(*args), shape)
    ref = _ref_draw(getattr(RI, name)(*args), shape)
    fi, fo = RI._fans(shape)
    if name.startswith("Xavier"):
        fi = args[0] if args else fi
        fo = args[1] if args else fo
        gain = args[2] if args else 1.0
        scale = gain * math.sqrt((6.0 if kind == "uniform" else 2.0)
                                 / (fi + fo))
    elif name.startswith("Kaiming"):
        fi = args[0] or fi if args else fi
        slope = args[1] if args else 0.0
        gain = RI.calculate_gain(args[2] if args else "relu", slope)
        scale = gain * (math.sqrt(3.0 / fi) if kind == "uniform"
                        else 1.0 / math.sqrt(fi))
    elif name == "Uniform":
        scale = args[1]
    else:
        scale = args[1]
    if kind == "uniform":
        assert np.abs(port).max() <= scale
        assert np.abs(port).max() > 0.99 * scale
        want_std = scale / math.sqrt(3.0)
    elif kind == "truncated":
        assert np.abs(port).max() <= 2.0
        want_std = 0.8796      # std of a standard normal cut at +-2
    else:
        want_std = scale
    assert abs(port.std() / want_std - 1) < 0.03
    assert abs(port.mean()) < 0.03 * want_std
    assert abs(port.std() / ref.std() - 1) < 0.05


@pytest.mark.parametrize("gain", [1.0, 0.5])
@pytest.mark.parametrize("shape", [(8, 16), (16, 8), (4, 3, 2, 8)])
def test_orthogonal(shape, gain):
    q = _draw(PI.Orthogonal(gain), shape).reshape(-1, shape[-1])
    r = _ref_draw(RI.Orthogonal(gain), shape).reshape(-1, shape[-1])
    for m in (q, r):
        small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(small, gain ** 2 * np.eye(len(small)),
                                   atol=1e-5)


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), (3, 4)),
    ("Assign", (np.arange(12.0).reshape(3, 4),), (3, 4)),
    ("Assign", (np.arange(6.0),), (2, 3)),
    ("Dirac", (), (4, 4, 3, 3)),
    ("Dirac", (2,), (6, 3, 3)),
    ("Bilinear", (), (2, 2, 4, 4)),
    ("Bilinear", (), (1, 3, 3, 5)),
])
def test_deterministic_initializers_exactly(name, args, shape):
    port_init = getattr(PI, name)(*args)
    ref_init = getattr(RI, name)(*args)
    if name == "Bilinear":
        t = paddle.zeros(list(shape))
        want = np.asarray(ref_init(t)._data)
    else:
        want = _ref_draw(ref_init, shape)
    np.testing.assert_array_equal(_draw(port_init, shape), want)
    # and in place on an existing tensor, as the reference's call
    p = torch.nn.Parameter(torch.empty(shape))
    assert port_init(p) is p
    np.testing.assert_array_equal(p.detach().numpy(), want)


@pytest.mark.parametrize("nl,param", [
    ("sigmoid", None), ("conv2d", None), ("linear", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.3),
    ("selu", None)])
def test_calculate_gain(nl, param):
    assert PI.calculate_gain(nl, param) == RI.calculate_gain(nl, param)


def test_unknown_nonlinearity_raises():
    with pytest.raises(ValueError):
        PI.calculate_gain("swish")


def test_in_place_call_draws_from_the_port_generator():
    pt.seed(3)
    a = PI.Normal()(torch.empty(64))
    pt.seed(3)
    b = PI.Normal()(torch.empty(64))
    torch.testing.assert_close(a, b, rtol=0, atol=0)

"""Activation functionals. reference: paddle_tpu/nn/functional/activation.py
(all of it); softmax, log_softmax and log_sigmoid are AMP black ops
(amp._cast). Where jax.nn's formula differs from torch's built-in, the
reference's is written out: softplus and mish by logaddexp(x, 0),
leaky_relu keeping x at 0, hardtanh by jnp.clip's min(max(x, lo), hi)
(whose gradient at a bound is halved). The in-place forms (`relu_`,
`elu_`, ...) write into x and return it (tensor/__init__.py's `_write`)."""

from __future__ import annotations

import torch

from ...amp import _cast
from ...framework.dtypes import convert_dtype
from ...framework.random import get_generator
from ...tensor import _write
from ...tensor.random import gumbel_softmax

__all__ = [
    "relu", "relu_", "hardtanh_", "leaky_relu_", "thresholded_relu_",
    "relu6", "elu", "elu_", "selu", "celu", "gelu", "silu", "swish", "mish",
    "softplus", "softshrink", "hardshrink", "tanhshrink", "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "softmax", "softmax_", "softsign", "thresholded_relu",
    "tanh", "tanh_", "prelu", "rrelu", "maxout", "glu", "gumbel_softmax",
]


def relu(x, name=None):
    return torch.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False, name=None):
    """x * Phi(x) by erf, or with approximate=True the tanh form
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), as jax.nn.gelu."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu6(x, name=None):
    """min(max(x, 0), 6); the gradient is 0 at 0 and 6, as jax.nn.relu6's."""
    return torch.nn.functional.relu6(x)


def swish(x, name=None):
    """x * sigmoid(x) (jax.nn.silu)."""
    return torch.nn.functional.silu(x)


def _clip(x, lo, hi):
    """jnp.clip's min(max(x, lo), hi): at x == lo or hi the gradient is
    halved, as lax.max's and lax.min's are (torch's clamp passes all of
    it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """clip(slope * x + offset, 0, 1) at the reference's slope 0.1666667,
    not torch's hardsigmoid (slope exactly 1/6)."""
    return _clip(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    """x * clip(x + 3, 0, 6) / 6."""
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _cast("softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _cast("log_softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def softsign(x, name=None):
    return x / (1 + x.abs())


def log_sigmoid(x, name=None):
    (x,) = _cast("log_sigmoid", x)
    return torch.nn.functional.logsigmoid(x)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(torch.clamp(x, max=0)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return torch.clamp(x, min=0) + alpha * torch.expm1(
        torch.clamp(x, max=0) / alpha)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """x where beta x > threshold, else softplus(beta x) / beta."""
    bx = beta * x
    return torch.where(bx > threshold, x, _softplus(bx) / beta)


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _clip(x, min, max)


def leaky_relu(x, negative_slope=0.01, name=None):
    """x where x >= 0, else negative_slope * x (jax.nn.leaky_relu)."""
    return torch.where(x >= 0, x, negative_slope * x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x,
                       torch.full((), value, dtype=x.dtype, device=x.device))


def prelu(x, weight, data_format="NCHW", name=None):
    """x where x > 0, else weight * x; a weight of one element for every
    channel, else one per channel (axis 1, or the last in NHWC-style
    formats)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
            weight.numel()
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """x where x >= 0, else r * x: r uniform on [lower, upper] in training
    (from the port's generator of x's device), (lower + upper) / 2
    outside it."""
    if training:
        r = torch.empty_like(x).uniform_(lower, upper,
                                         generator=get_generator(x.device))
    else:
        r = (lower + upper) / 2.0
    return torch.where(x >= 0, x, r * x)


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def relu_(x, name=None):
    return _write(x, relu(x))


def tanh_(x, name=None):
    return _write(x, tanh(x))


def elu_(x, alpha=1.0, name=None):
    return _write(x, elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _write(x, softmax(x, axis, dtype))


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return _write(x, hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _write(x, leaky_relu(x, negative_slope))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return _write(x, thresholded_relu(x, threshold, value))

"""Activation functionals. reference: paddle_tpu/nn/functional/activation.py
(`relu` :30, `tanh` :33, `silu` :34, `relu6` :53, `gelu` :68, `swish`
:72, `hardsigmoid` :96, `hardswish` :100, `softmax` :117,
`log_softmax` :130); softmax and log_softmax are AMP black ops
(amp._cast)."""

from __future__ import annotations

import torch

from ...amp import _cast
from ...framework.dtypes import convert_dtype

__all__ = ["relu", "tanh", "silu", "gelu", "relu6", "swish", "hardsigmoid",
           "hardswish", "softmax", "log_softmax"]


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

"""Activation layers. reference: paddle_tpu/nn/layer/activation.py (all of
it): `ReLU`, `ReLU6`, `Hardsigmoid`, `Hardswish` and `Swish` call their
functional with the arguments they were built with; the `_mk` family
(:15-55) does the same with whatever arguments it is given, and `PReLU`
owns its weight."""

from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer, _param

__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid", "Tanh",
           "Softmax", "LogSoftmax", "LogSigmoid", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "PReLU", "RReLU", "Mish",
           "Silu", "Swish", "Softplus", "Softshrink", "Softsign", "Tanhshrink",
           "ThresholdedReLU", "Maxout", "GLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class Hardsigmoid(Layer):
    def __init__(self, slope=0.1666667, offset=0.5, name=None):
        super().__init__()
        self.slope, self.offset = slope, offset

    def forward(self, x):
        return F.hardsigmoid(x, self.slope, self.offset)


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Swish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.swish(x)


def _mk(name, fname):
    """A layer calling F.<fname>(x, *args, **kwargs) with the arguments it
    was built with (`name` dropped)."""
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, fname)(x, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ELU = _mk("ELU", "elu")
SELU = _mk("SELU", "selu")
CELU = _mk("CELU", "celu")
GELU = _mk("GELU", "gelu")
Sigmoid = _mk("Sigmoid", "sigmoid")
Tanh = _mk("Tanh", "tanh")
LogSigmoid = _mk("LogSigmoid", "log_sigmoid")
Hardshrink = _mk("Hardshrink", "hardshrink")
Hardtanh = _mk("Hardtanh", "hardtanh")
LeakyReLU = _mk("LeakyReLU", "leaky_relu")
Mish = _mk("Mish", "mish")
Silu = _mk("Silu", "silu")
Softplus = _mk("Softplus", "softplus")
Softshrink = _mk("Softshrink", "softshrink")
Softsign = _mk("Softsign", "softsign")
Tanhshrink = _mk("Tanhshrink", "tanhshrink")
ThresholdedReLU = _mk("ThresholdedReLU", "thresholded_relu")
Maxout = _mk("Maxout", "maxout")
GLU = _mk("GLU", "glu")
Softmax = _mk("Softmax", "softmax")
LogSoftmax = _mk("LogSoftmax", "log_softmax")
RReLU = _mk("RReLU", "rrelu")


class PReLU(Layer):
    """F.prelu with a learned weight of `num_parameters` slopes, all
    `init` at first."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, dtype="float32",
                 device=None):
        super().__init__()
        self._data_format = data_format
        self.weight = _param(weight_attr, Constant(init), (num_parameters,),
                             dtype, device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)

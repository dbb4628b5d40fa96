"""Activation layers. reference: paddle_tpu/nn/layer/activation.py
(`ReLU`, `ReLU6`, `Hardsigmoid`, `Hardswish`, `Swish`: each calls its
functional with the arguments it was built with)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Hardsigmoid", "Hardswish", "Swish"]


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

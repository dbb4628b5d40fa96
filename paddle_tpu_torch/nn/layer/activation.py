"""Activation layers. reference: paddle_tpu/nn/layer/activation.py
(`ReLU6`, `Hardsigmoid`, `Hardswish`, `Swish`: each calls its functional
with the arguments it was built with)."""

from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU6", "Hardsigmoid", "Hardswish", "Swish"]


class ReLU6(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class Hardsigmoid(nn.Module):
    def __init__(self, slope=0.1666667, offset=0.5, name=None):
        super().__init__()
        self.slope, self.offset = slope, offset

    def forward(self, x):
        return F.hardsigmoid(x, self.slope, self.offset)


class Hardswish(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Swish(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.swish(x)

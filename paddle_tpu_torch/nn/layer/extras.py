"""Max unpooling layers. reference: paddle_tpu/nn/layer/extras.py
(`_MaxUnPoolN` :75, `MaxUnPool1D/2D/3D` :93-104). The rest of that file
is not ported."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


class _MaxUnPoolN(Layer):
    _ndim = 2

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        fn = getattr(F, f"max_unpool{self._ndim}d")
        return fn(x, indices, self.kernel_size, self.stride, self.padding,
                  output_size=self.output_size)


class MaxUnPool1D(_MaxUnPoolN):
    _ndim = 1


class MaxUnPool2D(_MaxUnPoolN):
    _ndim = 2


class MaxUnPool3D(_MaxUnPoolN):
    _ndim = 3

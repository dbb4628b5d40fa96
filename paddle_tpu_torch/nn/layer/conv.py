"""Convolution layers. reference: paddle_tpu/nn/layer/conv.py (`_ConvNd`
:19-48, `Conv1D`/`Conv2D`/`Conv3D` :51-89).

The weight is (out, in / groups, *kernel), the reference's layout and
torch's. Weight and bias both draw from Uniform(-1/sqrt(fan_in),
1/sqrt(fan_in)), fan_in = in / groups * prod(kernel), unless
`weight_attr` / `bias_attr` name an initializer; `bias_attr=False`
leaves the bias out. `padding_mode` other than "zeros" and transposed
convolutions are not ported; the first raises.
"""

from __future__ import annotations

import math

from torch import nn

from .. import functional as F
from ..initializer import Uniform
from .common import _param

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


class _ConvNd(nn.Module):
    _n = 0
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 dtype="float32", device=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r} is not ported; only 'zeros'")
        n = self._n
        ks = (kernel_size,) * n if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = ks
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format or ("NC" + "DHW"[3 - n:]
                                            if n > 1 else "NCL")
        bound = 1.0 / math.sqrt(in_channels // groups * math.prod(ks))
        self.weight = _param(weight_attr or Uniform(-bound, bound),
                             (out_channels, in_channels // groups) + ks,
                             dtype, device)
        self.bias = (None if bias_attr is False else
                     _param(bias_attr or Uniform(-bound, bound),
                            (out_channels,), dtype, device))

    def forward(self, x):
        return getattr(F, self._fn)(x, self.weight, self.bias, self._stride,
                                    self._padding, self._dilation,
                                    self._groups, self._data_format)


class Conv1D(_ConvNd):
    _n, _fn = 1, "conv1d"


class Conv2D(_ConvNd):
    _n, _fn = 2, "conv2d"


class Conv3D(_ConvNd):
    _n, _fn = 3, "conv3d"

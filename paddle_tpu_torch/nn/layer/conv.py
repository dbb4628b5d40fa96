"""Convolution layers. reference: paddle_tpu/nn/layer/conv.py (`_ConvNd`
:19-48, `Conv1D`/`Conv2D`/`Conv3D` :51-89, `Conv1DTranspose`/
`Conv2DTranspose`/`Conv3DTranspose` :91-142).

The weight is (out, in / groups, *kernel), or (in, out / groups, *kernel)
for a transposed convolution: the reference's layouts and torch's. Weight
and bias both draw from Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in =
in / groups * prod(kernel), unless `weight_attr` / `bias_attr` name an
initializer; `bias_attr=False` leaves the bias out. `padding_mode` other
than "zeros" is not ported and raises.
"""

from __future__ import annotations

import math


from .. import functional as F
from ..initializer import Uniform
from .common import _param
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _kernel_params(module, in_channels, out_channels, kernel_size, n,
                   groups, weight_attr, bias_attr, dtype, device,
                   transpose):
    """Set `module`'s weight and bias (None when bias_attr is False)."""
    ks = (kernel_size,) * n if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    module._kernel_size = ks
    bound = 1.0 / math.sqrt(in_channels // groups * math.prod(ks))
    shape = ((in_channels, out_channels // groups) if transpose
             else (out_channels, in_channels // groups)) + ks
    module.weight = _param(weight_attr, Uniform(-bound, bound), shape,
                           dtype, device)
    module.bias = _param(bias_attr, Uniform(-bound, bound), (out_channels,),
                         dtype, device)


def _default_format(n):
    return "NC" + "DHW"[3 - n:] if n > 1 else "NCL"


class _ConvNd(Layer):
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
        self._in_channels, self._out_channels = in_channels, out_channels
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format or _default_format(self._n)
        _kernel_params(self, in_channels, out_channels, kernel_size,
                       self._n, groups, weight_attr, bias_attr, dtype,
                       device, transpose=False)

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


class _ConvTransposeNd(Layer):
    """The reference's transposed-convolution layers: `output_size` given
    to forward overrides `output_padding`."""
    _n = 0

    def _build(self, in_channels, out_channels, kernel_size, stride,
               padding, output_padding, dilation, groups, weight_attr,
               bias_attr, data_format, dtype, device):
        self._in_channels, self._out_channels = in_channels, out_channels
        self._stride, self._padding = stride, padding
        self._output_padding = output_padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format or _default_format(self._n)
        _kernel_params(self, in_channels, out_channels, kernel_size,
                       self._n, groups, weight_attr, bias_attr, dtype,
                       device, transpose=True)

    def forward(self, x, output_size=None):
        opad = 0 if output_size is not None else self._output_padding
        fn = getattr(F, f"conv{self._n}d_transpose")
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  opad, self._groups, self._dilation, output_size,
                  self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _n = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 dtype="float32", device=None):
        super().__init__()
        self._build(in_channels, out_channels, kernel_size, stride, padding,
                    output_padding, dilation, groups, weight_attr,
                    bias_attr, data_format, dtype, device)


class Conv2DTranspose(_ConvTransposeNd):
    _n = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 dtype="float32", device=None):
        super().__init__()
        self._build(in_channels, out_channels, kernel_size, stride, padding,
                    output_padding, dilation, groups, weight_attr,
                    bias_attr, data_format, dtype, device)


class Conv3DTranspose(_ConvTransposeNd):
    _n = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 dtype="float32", device=None):
        super().__init__()
        self._build(in_channels, out_channels, kernel_size, stride, padding,
                    output_padding, dilation, groups, weight_attr,
                    bias_attr, data_format, dtype, device)

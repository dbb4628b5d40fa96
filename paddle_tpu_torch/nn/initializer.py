"""Parameter initializers. reference: paddle_tpu/nn/initializer/__init__.py
(all of it: `Constant`, `Normal`, `TruncatedNormal`, `Uniform`, the Xavier
and Kaiming pairs, `Assign`, `Orthogonal`, `Dirac`, `Bilinear`,
`calculate_gain`, `set_global_initializer`), the defaults of
`create_parameter` (nn/layer/layers.py:48-77) and of `Embedding`
(nn/layer/common.py:60).

An initializer is called two ways: `init(shape, dtype, device, generator)`
builds a new tensor (how the port's layers draw their parameters), and
`init(param)` fills an existing tensor in place and returns it (the
reference's call). Draws come from an explicit `torch.Generator`, the
port's generator of the device by default (framework/random.py), and do
not reproduce the JAX package's bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.random import get_generator

__all__ = ["Bilinear", "Initializer", "Constant", "Normal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "KaimingNormal", "KaimingUniform", "Assign", "Orthogonal",
           "Dirac", "calculate_gain", "set_global_initializer"]

# (weight, bias) initializers that set_global_initializer installed:
# create_parameter takes them where no ParamAttr names one
_GLOBAL = [None, None]


def set_global_initializer(weight_init, bias_init=None):
    _GLOBAL[0], _GLOBAL[1] = weight_init, bias_init


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle linear weight is (in, out)
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Base: subclasses define `_draw(shape, dtype, device, generator)`."""

    def _draw(self, shape, dtype, device, generator):
        raise NotImplementedError

    def __call__(self, param, dtype=None, device=None, generator=None):
        if isinstance(param, torch.Tensor):
            with torch.no_grad():
                param.copy_(self._draw(tuple(param.shape), param.dtype,
                                       param.device,
                                       get_generator(param.device)))
            return param
        return self._draw(tuple(param), dtype, device, generator)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, dtype, device, generator):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _draw(self, shape, dtype, device, generator):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """mean + std * z, z a standard normal truncated to [a, b] (bounds in
    units of std, as the reference's). Drawn in float32 and cast."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, shape, dtype, device, generator):
        z = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _draw(self, shape, dtype, device, generator):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    """Normal(0, gain * sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, device, generator):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return Normal(0.0, std)._draw(shape, dtype, device, generator)


class XavierUniform(Initializer):
    """Uniform(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out));
    each fan from the shape unless given."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, device, generator):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return Uniform(-limit, limit)._draw(shape, dtype, device, generator)


class KaimingNormal(Initializer):
    """Normal(0, gain / sqrt(fan_in)), gain = calculate_gain(nonlinearity,
    negative_slope)."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu", name=None):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, dtype, device, generator):
        fi = self.fan_in or _fans(shape)[0]
        std = calculate_gain(self.nonlinearity, self.slope) / math.sqrt(fi)
        return Normal(0.0, std)._draw(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    """Uniform(-limit, limit), limit = gain * sqrt(3 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu", name=None):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, dtype, device, generator):
        fi = self.fan_in or _fans(shape)[0]
        limit = (calculate_gain(self.nonlinearity, self.slope)
                 * math.sqrt(3.0 / fi))
        return Uniform(-limit, limit)._draw(shape, dtype, device, generator)


class Assign(Initializer):
    """The given value (a tensor, an array or a list), cast and reshaped."""

    def __init__(self, value, name=None):
        self.value = value

    def _draw(self, shape, dtype, device, generator):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.detach().to(device=device, dtype=dtype).reshape(shape).clone()


class Orthogonal(Initializer):
    """gain * an orthogonal matrix of (prod(shape[:-1]), shape[-1]) from
    the QR of a normal draw, signs fixed by R's diagonal, as
    jax.nn.initializers.orthogonal builds it."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _draw(self, shape, dtype, device, generator):
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        big, small = max(n_rows, n_cols), min(n_rows, n_cols)
        a = torch.empty(big, small, dtype=torch.float32, device=device)
        a.normal_(generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q).reshape(shape).to(dtype)


class Dirac(Initializer):
    """A convolution kernel (out, in, *spatial) that passes channel i of
    each group through at the centre tap."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _draw(self, shape, dtype, device, generator):
        arr = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        per_group = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_c)):
                arr[(g * per_group + i, i) + centers] = 1.0
        return torch.from_numpy(arr).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a 4-D transposed-convolution
    weight."""

    def _draw(self, shape, dtype, device, generator):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        kh, kw = shape[2], shape[3]
        f = np.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        grid = np.zeros(shape, np.float32)
        for i in range(kh):
            for j in range(kw):
                grid[:, :, i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
        return torch.from_numpy(grid).to(device=device, dtype=dtype)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "conv1d", "conv2d", "conv3d", "linear",
                        "conv_transpose1d", "conv_transpose2d",
                        "conv_transpose3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unsupported nonlinearity {nonlinearity}")

"""Parameter initializers. reference: paddle_tpu/nn/initializer/__init__.py
(`Constant`, `Normal`, `TruncatedNormal` :63, `Uniform`, `XavierUniform`),
the defaults of `create_parameter`
(nn/layer/layers.py:48-77) and of `Embedding` (nn/layer/common.py:60).

Each initializer builds a new tensor from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierUniform"]


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


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal:
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator=None):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal:
    """mean + std * z, z a standard normal truncated to [a, b] (bounds in
    units of std, as the reference's). Drawn in float32 and cast."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device, generator=None):
        z = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return (self.mean + self.std * z).to(dtype)


class Uniform:
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device, generator=None):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(self.low, self.high, generator=generator)


class XavierUniform:
    """Uniform(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out));
    each fan from the shape unless given."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(-limit, limit, generator=generator)

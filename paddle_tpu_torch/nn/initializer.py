"""Parameter initializers. reference: paddle_tpu/nn/initializer/__init__.py
(`Constant`, `Normal`, `XavierUniform`), the defaults of `create_parameter`
(nn/layer/layers.py:48-77) and of `Embedding` (nn/layer/common.py:60).

Each initializer builds a new tensor from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Constant", "Normal", "XavierUniform"]


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
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator=None):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.normal_(self.mean, self.std, generator=generator)


class XavierUniform:
    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(-limit, limit, generator=generator)

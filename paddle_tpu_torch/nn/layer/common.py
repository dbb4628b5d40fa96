"""Common layers. reference: paddle_tpu/nn/layer/common.py.

Parameter names and shapes follow the reference so that `state_dict()` keys
and shapes equal the JAX model's: `Linear.weight` is (in, out).
"""

from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.dtypes import convert_dtype
from ...framework.random import get_generator
from .. import functional as F
from ..initializer import Constant, Normal, XavierUniform

__all__ = ["Linear", "Embedding"]


def _param(init, shape, dtype, device):
    device = resolve_device(device)
    data = init(tuple(shape), convert_dtype(dtype), device,
                get_generator(device))
    return nn.Parameter(data)


class Linear(nn.Module):
    """y = x @ W + b with W (in_features, out_features); XavierUniform
    weight and zero bias, the defaults of the reference's create_parameter."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype="float32", device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param(XavierUniform(), (in_features, out_features),
                             dtype, device)
        self.bias = (_param(Constant(0.0), (out_features,), dtype, device)
                     if bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """Lookup table (num_embeddings, embedding_dim), Normal(0, 1) init."""

    def __init__(self, num_embeddings, embedding_dim, dtype="float32",
                 device=None):
        super().__init__()
        self.weight = _param(Normal(0.0, 1.0),
                             (num_embeddings, embedding_dim), dtype, device)

    def forward(self, ids: torch.Tensor):
        return F.embedding(ids, self.weight)

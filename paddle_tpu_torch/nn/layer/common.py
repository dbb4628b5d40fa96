"""Common layers. reference: paddle_tpu/nn/layer/common.py (`Linear` :26,
`Embedding` :48, `Dropout` :69) and `create_parameter`'s defaults
(nn/layer/layers.py:48-77).

Each layer takes the reference's parameters in the reference's order,
`name` included (accepted and ignored, as there), and then the port's own
`dtype` and `device` as keyword-only parameters.

Parameter names and shapes follow the reference so that `state_dict()` keys
and shapes equal the JAX model's: `Linear.weight` is (in, out).
`weight_attr` and `bias_attr` take a `ParamAttr` (its initializer,
`trainable`, `name` and `learning_rate`, as the reference's
`create_parameter` reads them), an initializer (nn/initializer.py), or
None for the reference's default; `bias_attr=False` leaves the bias out.
"""

from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal
from .layers import Layer, _param

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x @ W + b with W (in_features, out_features); XavierUniform
    weight and zero bias (or the global initializers) unless `weight_attr`
    / `bias_attr` name an initializer."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype="float32", device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param(weight_attr, None, (in_features, out_features),
                             dtype, device)
        self.bias = _param(bias_attr, None, (out_features,), dtype, device,
                           is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Lookup table (num_embeddings, embedding_dim), Normal(0, 1) unless
    `weight_attr` names an initializer. The row at `padding_idx` (negative:
    counted from the end) starts at zero and its lookups give zeros.
    `sparse` is accepted and ignored, as the reference does."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 dtype="float32", device=None):
        super().__init__()
        self.padding_idx = (padding_idx if padding_idx is None
                            or padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.weight = _param(weight_attr, Normal(0.0, 1.0),
                             (num_embeddings, embedding_dim), dtype, device)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, ids: torch.Tensor):
        return F.embedding(ids, self.weight, self.padding_idx)


class Dropout(Layer):
    """F.dropout with the module's training flag."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

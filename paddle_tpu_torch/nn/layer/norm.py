"""Normalization layers. reference: paddle_tpu/nn/layer/norm.py (`LayerNorm`
:80, `RMSNorm` :99)."""

from __future__ import annotations

from torch import nn

from .. import functional as F
from ..initializer import Constant
from .common import _param

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` axes; weight ones and
    bias zeros unless `weight_attr` / `bias_attr` name an initializer, and
    left out when False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, dtype="float32", device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       _param(weight_attr or Constant(1.0),
                              self.normalized_shape, dtype, device))
        self.bias = (None if bias_attr is False else
                     _param(bias_attr or Constant(0.0),
                            self.normalized_shape, dtype, device))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class RMSNorm(nn.Module):
    """Llama-family RMSNorm with a ones-initialized weight."""

    def __init__(self, hidden_size, epsilon=1e-6, dtype="float32",
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(Constant(1.0), (hidden_size,), dtype, device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

"""Normalization layers. reference: paddle_tpu/nn/layer/norm.py:99 RMSNorm."""

from __future__ import annotations

from torch import nn

from .. import functional as F
from ..initializer import Constant
from .common import _param

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """Llama-family RMSNorm with a ones-initialized weight."""

    def __init__(self, hidden_size, epsilon=1e-6, dtype="float32",
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(Constant(1.0), (hidden_size,), dtype, device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

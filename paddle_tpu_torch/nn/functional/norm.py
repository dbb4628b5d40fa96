"""Normalization functionals. reference: paddle_tpu/nn/functional/norm.py."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm in the reference's rounding order (norm.py:101-112): the mean
    square and the normalization in fp32, cast back to x's dtype, and only
    then the multiply by the weight."""
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out

"""Normalization functionals. reference: paddle_tpu/nn/functional/norm.py
(`layer_norm` :78-98, `rms_norm` :101-112)."""

from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` axes in the
    reference's rounding order: mean, variance and the normalization in
    fp32, cast back to x's dtype, and only then the multiply by the weight
    and the add of the bias, in that dtype (torch's layer_norm applies
    them in fp32, which rounds bf16 differently)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=dims, keepdim=True, correction=0)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


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

"""Normalization functionals. reference: paddle_tpu/nn/functional/norm.py
(`batch_norm` :19-76, `layer_norm` :78-98, `rms_norm` :101-112)."""

from __future__ import annotations

import torch

from ...amp import _cast
from ...framework.dtypes import rounded

__all__ = ["batch_norm", "layer_norm", "rms_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalization over every axis but the channel's, in the
    reference's rounding order.

    With running statistics (eval, or `use_global_stats`):
    (x - rm) * rsqrt(rv + eps), then the weight and the bias, then a cast
    to x's dtype. In training: the batch mean and population variance in
    float32 (float64 for a float64 x), each cast to x's dtype before
    (x - m) * rsqrt(v + eps), then
    the weight and the bias in x's dtype (torch's batch_norm applies them
    in float32 and rounds bf16 once, differently). Training also updates
    the running statistics in place, Paddle's way round:
    r = momentum * r + (1 - momentum) * batch, the variance unbiased by
    n / (n - 1), in the buffers' own dtype."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if use_stats:
        x, running_mean, running_var, weight, bias = _cast(
            "batch_norm", x, running_mean, running_var, weight, bias)
        rv = running_var.reshape(shape)
        out = (x - running_mean.reshape(shape)) * torch.rsqrt(
            rv + rounded(epsilon, rv.dtype))
    else:
        x, weight, bias = _cast("batch_norm", x, weight, bias)
        axes = tuple(i for i in range(x.dim()) if i != ch)
        v, m = torch.var_mean(x.to(torch.promote_types(x.dtype,
                                                       torch.float32)),
                              dim=axes, correction=0)
        out = (x - m.reshape(shape).to(x.dtype)) * torch.rsqrt(
            v.reshape(shape).to(x.dtype) + rounded(epsilon, x.dtype))
        with torch.no_grad():
            n = x.numel() // x.shape[ch]
            unbiased = v * rounded(n / max(n - 1, 1), v.dtype)
            for r, batch in ((running_mean, m), (running_var, unbiased)):
                if r is not None:
                    r.copy_(rounded(momentum, r.dtype) * r
                            + rounded(1.0 - momentum, r.dtype)
                            * batch.to(r.dtype))
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing `normalized_shape` axes in the
    reference's rounding order: mean, variance and the normalization in
    fp32, cast back to x's dtype, and only then the multiply by the weight
    and the add of the bias, in that dtype (torch's layer_norm applies
    them in fp32, which rounds bf16 differently)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    x, weight, bias = _cast("layer_norm", x, weight, bias)
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=dims, keepdim=True, correction=0)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm in the reference's rounding order (norm.py:101-112): the mean
    square and the normalization in fp32, cast back to x's dtype, and only
    then the multiply by the weight."""
    x, weight = _cast("rms_norm", x, weight)
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out

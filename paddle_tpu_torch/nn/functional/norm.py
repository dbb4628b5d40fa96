"""Normalization functionals. reference: paddle_tpu/nn/functional/norm.py
(all of it: `batch_norm` :19-76, `layer_norm` :78-98, `rms_norm`
:101-112, `instance_norm`, `group_norm` and `local_response_norm`
:115-186). Group and instance norm take their statistics as the
reference's jnp.mean and jnp.var do (summed in float32, rounded to the
input's dtype) and normalize in the input's dtype."""

from __future__ import annotations

import torch

from ...amp import _cast
from ...framework.dtypes import rounded

__all__ = ["batch_norm", "layer_norm", "rms_norm", "instance_norm",
           "group_norm", "local_response_norm"]


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


def _normalize(g, dims, eps):
    """(g - mean) * rsqrt(var + eps) over `dims`, the statistics summed in
    float32 and rounded to g's dtype."""
    var, mean = torch.var_mean(g.float(), dim=dims, keepdim=True,
                               correction=0)
    return (g - mean.to(g.dtype)) * torch.rsqrt(var.to(g.dtype) + eps)


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalized over their spatial axes. The
    running statistics are accepted and not used, as the reference does."""
    x, weight, bias = _cast("instance_norm", x, weight, bias)
    first = data_format.startswith("NC")
    dims = tuple(range(2, x.dim())) if first else tuple(range(1, x.dim() - 1))
    shape = [1] * x.dim()
    shape[1 if first else -1] = x.shape[1 if first else -1]
    return _affine(_normalize(x, dims, eps), weight, bias, shape).to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Each sample's channels in `num_groups` groups, each normalized over
    its channels and the spatial axes; NCHW or channels-last."""
    x, weight, bias = _cast("group_norm", x, weight, bias)
    shape = [1] * x.dim()
    if data_format == "NCHW" or x.dim() == 2:
        n, c = x.shape[:2]
        g = x.reshape((n, num_groups, c // num_groups) + x.shape[2:])
        dims = tuple(range(2, g.dim()))
        shape[1] = c
    else:
        n, c = x.shape[0], x.shape[-1]
        g = x.reshape(x.shape[:-1] + (num_groups, c // num_groups))
        dims = tuple(range(1, g.dim() - 2)) + (g.dim() - 1,)
        shape[-1] = c
    out = _normalize(g, dims, epsilon).reshape(x.shape)
    return _affine(out, weight, bias, shape).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * s)^beta, s the sum of squares over `size`
    neighbouring channels (the reference's sum, not torch's mean)."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    moved = torch.movedim(x * x, ch, -1)
    lo = (size - 1) // 2
    padded = torch.nn.functional.pad(moved, (lo, size - 1 - lo))
    n = moved.shape[-1]
    s = torch.stack([padded[..., i:i + n] for i in range(size)], -1).sum(-1)
    return x / (k + alpha * torch.movedim(s, -1, ch)) ** beta

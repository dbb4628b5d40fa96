"""Statistics. reference: paddle_tpu/tensor/stat.py (all of it).

`median(mode="avg")` is jnp.median, the mean of the two middle values for
an even count (torch.median returns the lower one); `mode="min"` returns
the lower median and its index. `quantile`/`nanquantile` follow
jnp.quantile's algorithm for each `interpolation` (its "nearest" takes
the lower value at a tie, where torch's rounds half to even). `std` and
`var` are unbiased by default.
"""

from __future__ import annotations

import torch

from .manipulation import numel
from .math import _inexact, mean

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "numel"]


def _dims(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % ndim for a in axis)
    return int(axis) % ndim


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_inexact(x), _dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_inexact(x), _dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _to_last(a, axis):
    """(a with the reduced axes flattened into its last one, the shape a
    keepdim result takes)."""
    if axis is None:
        return a.reshape(-1), [1] * a.dim()
    dims = (axis,) if isinstance(axis, int) else axis
    rest = [d for d in range(a.dim()) if d not in dims]
    keep = [1 if d in dims else s for d, s in enumerate(a.shape)]
    moved = a.permute(rest + list(dims))
    return moved.reshape(moved.shape[:len(rest)] + (-1,)), keep


def _quantile(x, q, axis, keepdim, method, squash_nans):
    """jnp.quantile / jnp.nanquantile (jax/_src/numpy/reductions.py
    `_quantile`): sort, then the values at floor and ceil of q (n - 1)."""
    if method not in ("linear", "lower", "higher", "midpoint", "nearest"):
        raise ValueError("interpolation can only be 'linear', 'lower', "
                         "'higher', 'midpoint', or 'nearest'")
    a = _inexact(x)
    a, keep = _to_last(a, _dims(axis, a.dim()))
    qv = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    scalar_q = qv.dim() == 0
    qv = qv.reshape(-1, *([1] * a.dim()))       # (nq, ..., 1)
    if squash_nans:
        a = torch.sort(a, -1).values                  # nan sorts last
        counts = (~torch.isnan(a)).sum(-1, keepdim=True).to(a.dtype)
    else:
        a = torch.where(torch.isnan(a).any(-1, keepdim=True),
                        torch.full_like(a, float("nan")), a)
        a = torch.sort(a, -1).values
        counts = torch.full((1,), a.shape[-1], dtype=a.dtype,
                            device=a.device)
    pos = qv * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    a = a.expand(qv.shape[0], *a.shape)
    low_v = torch.gather(a, -1, low.long().expand(*a.shape[:-1], 1))[..., 0]
    high_v = torch.gather(a, -1, high.long().expand(*a.shape[:-1], 1))[..., 0]
    low_w, high_w = low_w[..., 0], high_w[..., 0]
    if method == "linear":
        out = low_v * low_w + high_v * high_w
    elif method == "lower":
        out = low_v
    elif method == "higher":
        out = high_v
    elif method == "nearest":
        out = torch.where(high_w <= 0.5, low_v, high_v)
    else:
        out = (low_v + high_v) * 0.5
    if keepdim:
        out = out.reshape(out.shape[:1] + tuple(keep))
    return out[0] if scalar_q else out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """mode "avg": the middle value, or the mean of the two middle ones;
    mode "min": (the lower middle value, its index in a stable sort)."""
    if mode == "avg":
        return _quantile(x, 0.5, axis, keepdim, "midpoint", False)
    if axis is None:
        flat = x.reshape(-1)
        k = (flat.numel() - 1) // 2
        s = torch.sort(flat, stable=True)
        return s.values[k], s.indices[k]
    ax = int(axis) % x.dim()
    k = (x.shape[ax] - 1) // 2
    s = torch.sort(x, dim=ax, stable=True)
    v, i = s.values.select(ax, k), s.indices.select(ax, k)
    if keepdim:
        v, i = v.unsqueeze(ax), i.unsqueeze(ax)
    return v, i


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    """The median of the values that are not NaN (jnp.nanmedian)."""
    return _quantile(x, 0.5, axis, keepdim, "midpoint", True)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(x, q, axis, keepdim, interpolation, False)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(x, q, axis, keepdim, interpolation, True)

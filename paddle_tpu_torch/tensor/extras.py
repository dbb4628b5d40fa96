"""Less common tensor functions. reference: paddle_tpu/tensor/extras.py
(all of it), exported at the top level as there.

`cdist` and `pdist` take the square root of max(sum of squares, 1e-30) at
p = 2, as the reference does, so equal rows are 1e-15 apart; `renorm`
scales by max_norm / max(norm, 1e-12); `take` clamps an index out of range
in mode "raise" as the reference does (it cannot trap on its device).
"""

from __future__ import annotations

import itertools

import torch

from .linalg import _bin_edges
from .math import _inexact

__all__ = [
    "add_n", "block_diag", "broadcast_shape", "cartesian_prod", "cdist",
    "combinations", "diag_embed", "frexp", "gammainc", "gammaincc",
    "gammaln", "histogram_bin_edges", "index_fill", "isin", "logcumsumexp",
    "masked_scatter", "multigammaln", "pdist", "polygamma", "reduce_as",
    "renorm", "reverse", "sgn", "signbit", "sinc", "take", "trace",
    "vander", "as_strided",
]


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for a in inputs[1:]:
        out = out + a
    return out


def block_diag(inputs, name=None):
    return torch.block_diag(*(a if a.dim() == 2 else a.reshape(1, -1)
                              for a in inputs))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def cartesian_prod(x, name=None):
    grids = torch.meshgrid(*x, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], -1)


def _p_dist(d, p, count_zero=True):
    """The p-norm of differences d along the last axis (p = 0: the count
    of nonzero ones, where `count_zero`)."""
    if p == 2.0:
        return torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-30))
    if p == float("inf"):
        return d.abs().amax(-1)
    if p == 0 and count_zero:
        return (d != 0).to(d.dtype).sum(-1)
    return (d.abs() ** p).sum(-1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Distances between the rows of x and of y."""
    return _p_dist(x[..., :, None, :] - y[..., None, :, :], p)


def pdist(x, p=2.0, name=None):
    """Distances between the rows of x, upper triangle in row order."""
    n = x.shape[0]
    m = _p_dist(x[:, None, :] - x[None, :, :], p, count_zero=False)
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return m[iu[0], iu[1]]


def combinations(x, r=2, with_replacement=False, name=None):
    n = int(x.shape[0])
    pick = (itertools.combinations_with_replacement if with_replacement
            else itertools.combinations)
    idx = torch.tensor(list(pick(range(n), r)), dtype=torch.int64,
                       device=x.device).reshape(-1, r)
    return x[idx]


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """Each vector along the last axis as a diagonal (at `offset`) of a
    matrix over dims dim1 and dim2."""
    k = input.shape[-1]
    m = k + abs(offset)
    out = input.new_zeros(input.shape[:-1] + (m, m))
    i = torch.arange(k, device=input.device)
    out[..., i + max(-offset, 0), i + max(offset, 0)] = input
    nd = out.dim()
    return torch.movedim(out, (nd - 2, nd - 1), (dim1 % nd, dim2 % nd))


def frexp(x, name=None):
    """(mantissa in [0.5, 1), int32 exponent)."""
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


def gammaln(x, name=None):
    return torch.lgamma(_inexact(x))


def gammainc(x, y, name=None):
    return torch.special.gammainc(_inexact(x), _inexact(y))


def gammaincc(x, y, name=None):
    return torch.special.gammaincc(_inexact(x), _inexact(y))


def multigammaln(x, p, name=None):
    return torch.special.multigammaln(_inexact(x), p)


def polygamma(x, n, name=None):
    return torch.special.polygamma(n, _inexact(x))


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    a = _inexact(input).reshape(-1)
    if min == 0 and max == 0:
        return _bin_edges(a, bins)
    return _bin_edges(a, bins, min, max)


def index_fill(x, index, axis, value, name=None):
    return x.index_fill(axis, index, value)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, assume_unique=assume_unique, invert=invert)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    """log(cumsum(exp(x))) in float32, flattened without `axis`."""
    a, ax = (x.reshape(-1), 0) if axis is None else (x, axis)
    out = torch.logcumsumexp(a.to(torch.float32), ax)
    if not x.dtype.is_floating_point:
        return out
    return out.to(x.dtype if dtype is None else dtype)


def masked_scatter(x, mask, value, name=None):
    """x with its masked positions filled by value's elements in order."""
    return x.masked_scatter(mask.expand(x.shape), value)


def reduce_as(x, target, name=None):
    """x summed down to target's shape (the gradient of a broadcast)."""
    extra = x.dim() - target.dim()
    if extra:
        x = x.sum(tuple(range(extra)))
    axes = tuple(i for i in range(x.dim())
                 if target.shape[i] == 1 and x.shape[i] != 1)
    return x.sum(axes, keepdim=True) if axes else x


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along `axis` scaled down to p-norm max_norm where it is
    above it."""
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    if p == float("inf"):
        norms = flat.abs().amax(1)
    else:
        norms = (flat.abs() ** p).sum(1) ** (1.0 / p)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return torch.movedim((flat * scale[:, None]).reshape(moved.shape), 0,
                         axis)


def reverse(x, axis, name=None):
    return torch.flip(x, axis if isinstance(axis, (list, tuple)) else [axis])


def sgn(x, name=None):
    """x / |x| (0 at 0) for complex x, sign(x) for real."""
    if x.is_complex():
        mag = x.abs()
        return torch.where(mag == 0, torch.zeros_like(x),
                           x / torch.clamp(mag, min=1e-30))
    return torch.sign(x)


def signbit(x, name=None):
    return torch.signbit(x)


def sinc(x, name=None):
    return torch.sinc(_inexact(x))


def take(x, index, mode="raise", name=None):
    """Elements of flattened x at `index`: modulo its size in mode "wrap",
    else clamped to [-n, n - 1] and counted from the end when negative."""
    flat = x.reshape(-1)
    n = flat.numel()
    idx = torch.remainder(index, n) if mode == "wrap" else \
        torch.clamp(index, -n, n - 1)
    return flat[torch.where(idx < 0, idx + n, idx)]


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def vander(x, n=None, increasing=False, name=None):
    return torch.vander(x, N=n, increasing=increasing)


def as_strided(x, shape, stride, offset=0, name=None):
    """The elements of flattened x at offset + sum(i_k * stride_k)."""
    return torch.as_strided(x.contiguous().reshape(-1),
                            tuple(int(s) for s in shape),
                            tuple(int(s) for s in stride), int(offset))

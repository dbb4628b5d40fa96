"""Pooling. reference: paddle_tpu/nn/functional/pooling.py (`_pads` :21,
`_ceil_extra` :34, `_pool_geometry` :50, `_pool` :72-126, the max and avg
pools :129-202 with `_max_pool_indices` :137, `_adaptive` :205-224 and its
entry points, `lp_pool1d/2d` :238-262).

The reference pools with `lax.reduce_window` over explicit (low, high)
pads, `ceil_mode` folded in as extra high padding. The port resolves the
same pads. A max pool whose pads torch's own pooling takes (symmetric, at
most half the window) calls it directly, `ceil_mode` included (its output
size rule is the reference's); other pads are applied with -inf first.
`return_mask` gives the reference's indices, flat over the spatial dims:
the largest value of each window, a non-finite one counted as -inf, and
of equal ones the lowest index (a pad never wins). An avg pool sums each
window in float32 (`divisor_override=1` over zero-padded input) and
divides by the reference's divisor: the window's real elements with
`exclusive`, else the whole window, except that with `ceil_mode` the
extra high padding is never counted. Adaptive pools take torch's, whose
bins are the reference's: floor(i * in / out) to ceil((i + 1) * in / out);
the adaptive max pools' `return_mask` gives (out, None), as the
reference's. An lp pool is the reference's: the non-exclusive avg pool of
|x|^p times the window's size, to the power 1/p (torch's lp_pool pools
x^p, without the absolute value).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .conv import _tuple, same_pads

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                 3: TF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}


def _pads(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    p = list(padding)
    if len(p) == n:
        return [(int(v), int(v)) for v in p]
    if len(p) == 2 * n:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _ceil_extra(pad, spatial, ks, sd):
    """Extra high padding per spatial dim that gives the reference's
    ceil_mode output size, including its clamp: a last window that would
    start beyond the input and the low pad is dropped."""
    extra = []
    for size, (lo, hi), k, s in zip(spatial, pad, ks, sd):
        total = size + lo + hi
        out = math.ceil(max(total - k, 0) / s) + 1
        if (out - 1) * s >= size + lo:
            out -= 1
        extra.append(max((out - 1) * s + k - total, 0))
    return extra


def _flat(pads):
    """[(low, high)] per spatial dim -> F.pad's list, last dim first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _geometry(spatial, kernel, stride, padding, n, ceil_mode):
    """(window, strides, user pads, ceil extras) of one pooling call; a
    string padding counts as user padding."""
    ks = _tuple(kernel, n)
    sd = _tuple(stride if stride is not None else kernel, n)
    pad = _pads(padding, n)
    if isinstance(pad, str):
        if ceil_mode:
            raise ValueError("ceil_mode with string padding is unsupported")
        if pad not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME, VALID or ints, got "
                             f"{pad!r}")
        pad = (same_pads(spatial, ks, sd, (1,) * n) if pad == "SAME"
               else [(0, 0)] * n)
        return ks, sd, pad, [0] * n
    extra = _ceil_extra(pad, spatial, ks, sd) if ceil_mode else [0] * n
    return ks, sd, pad, extra


def _channels_first(x, data_format, fn):
    if data_format.startswith("NC"):
        return fn(x)
    return fn(x.movedim(-1, 1)).movedim(1, -1)


def _max_pool(x, kernel, stride, padding, n, ceil_mode, data_format):
    def f(a):
        ks, sd, pad, extra = _geometry(a.shape[2:], kernel, stride,
                                       padding, n, ceil_mode)
        if all(lo == hi <= k // 2 for (lo, hi), k in zip(pad, ks)):
            return _MAX[n](a, ks, sd, tuple(lo for lo, _ in pad),
                           ceil_mode=ceil_mode)
        full = [(lo, hi + e) for (lo, hi), e in zip(pad, extra)]
        return _MAX[n](TF.pad(a, _flat(full), value=-math.inf), ks, sd)
    return _channels_first(x, data_format, f)


def _window_sum(a, ks, sd, n):
    """The sum of every window of an already padded (N, C, *spatial)
    tensor."""
    if n == 1:
        return TF.avg_pool2d(a.unsqueeze(-2), (1,) + ks, (1,) + sd,
                             divisor_override=1).squeeze(-2)
    pool = TF.avg_pool2d if n == 2 else TF.avg_pool3d
    return pool(a, ks, sd, divisor_override=1)


def _avg_pool(x, kernel, stride, padding, n, ceil_mode, exclusive,
              data_format):
    string_pad = isinstance(padding, str)

    def f(a):
        spatial = a.shape[2:]
        ks, sd, pad, extra = _geometry(spatial, kernel, stride, padding, n,
                                       ceil_mode)
        full = [(lo, hi + e) for (lo, hi), e in zip(pad, extra)]
        s = _window_sum(TF.pad(a.float(), _flat(full)), ks, sd, n)
        if string_pad or not (exclusive or ceil_mode):
            return (s / math.prod(ks)).to(a.dtype)
        # the divisor: the count of a ones tensor's window, padded with 0
        # where padding is not counted (all of it when exclusive, the ceil
        # extras only otherwise) and with 1 where it is
        ones = torch.ones((1, 1) + tuple(spatial), device=a.device)
        if not exclusive:
            ones = TF.pad(ones, _flat(pad), value=1.0)
            full = [(0, e) for e in extra]
        cnt = _window_sum(TF.pad(ones, _flat(full)), ks, sd, n)
        return (s / cnt).to(a.dtype)
    return _channels_first(x, data_format, f)


def _max_pool_indices(x, kernel, stride, padding, n, ceil_mode,
                      data_format):
    """The reference's return_mask: each window's argmax, flat over the
    spatial dims (int64), read from the windows of the padded input."""
    def f(a):
        spatial = tuple(a.shape[2:])
        size = math.prod(spatial)
        ks, sd, pad, extra = _geometry(spatial, kernel, stride, padding, n,
                                       ceil_mode)
        full = _flat([(lo, hi + e) for (lo, hi), e in zip(pad, extra)])
        vals = TF.pad(torch.where(torch.isfinite(a), a, -math.inf), full,
                      value=-math.inf)
        idx = TF.pad(torch.arange(size, device=a.device).reshape(
            (1, 1) + spatial), full, value=size)
        for d in range(n):
            vals = vals.unfold(2 + d, ks[d], sd[d])
            idx = idx.unfold(2 + d, ks[d], sd[d])
        win = tuple(range(-n, 0))
        top = vals.amax(dim=win, keepdim=True)
        return torch.where(vals == top, idx, size).amin(dim=win)
    return _channels_first(x, data_format, f)


def _max_pool_nd(x, kernel_size, stride, padding, return_mask, ceil_mode,
                 data_format, n):
    out = _max_pool(x, kernel_size, stride, padding, n, ceil_mode,
                    data_format)
    if not return_mask:
        return out
    with torch.no_grad():
        mask = _max_pool_indices(x, kernel_size, stride, padding, n,
                                 ceil_mode, data_format)
    return out, mask


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool_nd(x, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool_nd(x, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool_nd(x, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     exclusive, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW", name=None):
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not ported")
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not ported")
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _ADAPTIVE_AVG[1](x, output_size)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _channels_first(
        x, data_format, lambda a: _ADAPTIVE_AVG[2](a, output_size))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _channels_first(
        x, data_format, lambda a: _ADAPTIVE_AVG[3](a, output_size))


def _adaptive_max(x, output_size, return_mask, n):
    out = _ADAPTIVE_MAX[n](x, output_size)
    return (out, None) if return_mask else out


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, return_mask, 1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, return_mask, 2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, return_mask, 3)


def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
             data_format, n):
    p = float(norm_type)
    s = _avg_pool(x.abs() ** p, kernel_size, stride, padding, n, ceil_mode,
                  False, data_format)
    return (s * float(math.prod(_tuple(kernel_size, n)))) ** (1.0 / p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    data_format, 1)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    data_format, 2)

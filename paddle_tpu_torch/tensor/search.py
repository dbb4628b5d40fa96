"""Search and sort. reference: paddle_tpu/tensor/search.py (all of it;
`index_sample`, `masked_select`, `nonzero` and `where` live in
manipulation.py there and here).

Index results are int64. `unique` and `unique_consecutive` have a size
that depends on the data, so they run on the host with numpy, as the
reference's do, and return tensors on x's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.dtypes import convert_dtype
from ..framework.random import get_generator
from .manipulation import index_sample, masked_select, nonzero, where

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "top_k", "searchsorted",
    "index_sample", "masked_select", "nonzero", "where", "mode", "kthvalue",
    "unique", "unique_consecutive", "bucketize", "top_p_sampling",
]


def _arg(f, x, axis, keepdim, dtype):
    if axis is None:
        r = f(x.reshape(-1))
        r = r.reshape((1,) * x.dim()) if keepdim else r
    else:
        r = f(x, dim=axis, keepdim=keepdim)
    return r.to(convert_dtype(dtype)) if dtype else r


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first index of the largest value, over all of x when `axis` is
    None."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(x, dim=axis, descending=descending,
                      stable=stable).indices


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(x, dim=axis, descending=descending,
                      stable=stable).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the k largest (or smallest) along `axis`
    (the last by default), sorted."""
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    r = torch.topk(x, k, dim=-1 if axis is None else axis, largest=largest,
                   sorted=True)
    return r.values, r.indices


top_k = topk


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    r = torch.searchsorted(sorted_sequence, values, right=right)
    return r.to(torch.int32 if out_int32 else torch.int64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def mode(x, axis=-1, keepdim=False, name=None):
    """(value, index) of the most frequent value along `axis`. Among equally
    frequent values the reference picks the first in sorted order (its
    float32 tie-break term, 1e-9 per position, is below a count's
    rounding), and the index is that value's first in a stable sort."""
    ax = axis % x.dim()
    moved = x.movedim(ax, -1)
    n = moved.shape[-1]
    s, si = torch.sort(moved, dim=-1, stable=True)
    eq = s[..., 1:] == s[..., :-1]
    runid = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.int64),
                       torch.cumsum((~eq).long(), -1)], -1)
    counts = torch.zeros_like(runid).scatter_add_(-1, runid,
                                                  torch.ones_like(runid))
    per = counts.gather(-1, runid)
    score = per.float() + torch.arange(n, device=x.device).float() * 1e-9
    best = torch.argmax(score, dim=-1, keepdim=True)
    vals = s.gather(-1, best)[..., 0]
    idxs = si.gather(-1, best)[..., 0]
    if keepdim:
        vals, idxs = vals.unsqueeze(ax), idxs.unsqueeze(ax)
    return vals, idxs


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(value, index) of the k-th smallest along `axis`, the index from a
    stable sort."""
    s, si = torch.sort(x, dim=axis, stable=True)
    vals = s.select(axis, k - 1)
    idxs = si.select(axis, k - 1)
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs


def _back(arr, like, integer=False):
    t = torch.as_tensor(np.asarray(arr).astype(np.int64) if integer
                        else np.asarray(arr))
    return t.to(like.device)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    res = np.unique(x.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _back(res, x)
    return tuple(_back(r, x, i > 0) for i, r in enumerate(res))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = x.detach().cpu().numpy()
    if axis is None:
        a = a.reshape(-1)
        keep = np.concatenate([[True], a[1:] != a[:-1]])
    else:
        n = a.shape[axis]
        diff = a.take(range(1, n), axis) != a.take(range(0, n - 1), axis)
        if diff.ndim > 1:
            diff = diff.any(axis=tuple(i for i in range(diff.ndim)
                                       if i != axis))
        keep = np.concatenate([[True], diff])
    outs = [_back(a[keep] if axis is None else np.compress(keep, a, axis),
                  x)]
    if return_inverse:
        outs.append(_back(np.cumsum(keep) - 1, x, True))
    if return_counts:
        idx = np.flatnonzero(keep)
        n = a.shape[0] if axis is None else a.shape[axis]
        outs.append(_back(np.diff(np.append(idx, n)), x, True))
    return outs[0] if len(outs) == 1 else tuple(outs)


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus sampling over probability rows x (batch, vocab) with per-row
    cutoffs ps (batch,): (value, id), each (batch, 1), plus the top-k
    scores and ids with `return_top`. 'truncated' keeps the tokens whose
    preceding mass in descending order is below p (the first always);
    'non-truncated' samples every token above `threshold`. Draws come from
    the port's generator of x's device, from `seed` when it is >= 0, or
    one generator per row from `topp_seed`; they are torch's own and do
    not reproduce the reference's JAX draws."""
    if mode not in ("truncated", "non-truncated"):
        raise ValueError(f"mode must be 'truncated' or 'non-truncated', "
                         f"got {mode!r}")
    src = x
    if threshold is not None:
        src = torch.where(x >= threshold[..., None], x, 0.0)
    sort_idx = torch.argsort(-src, dim=-1, stable=True)
    sorted_p = src.gather(-1, sort_idx)
    if mode == "truncated":
        cum = torch.cumsum(sorted_p, -1)
        sorted_p = torch.where((cum - sorted_p) < ps[..., None], sorted_p,
                               0.0)
    probs = sorted_p.float()
    if topp_seed is not None:
        pos = torch.cat([
            torch.multinomial(probs[i:i + 1], 1, generator=torch.Generator(
                device=x.device).manual_seed(int(s)))
            for i, s in enumerate(topp_seed.tolist())])
    else:
        gen = (get_generator(x.device) if seed < 0 else
               torch.Generator(device=x.device).manual_seed(int(seed)))
        pos = torch.multinomial(probs, 1, generator=gen)
    idx = sort_idx.gather(-1, pos)
    outs = (x.gather(-1, idx), idx)
    if return_top:
        top = torch.topk(x, k if k > 0 else 1, dim=-1)
        outs = outs + (top.values, top.indices)
    return outs

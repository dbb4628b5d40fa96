"""Linear algebra. reference: paddle_tpu/tensor/linalg.py (all of it).

Decompositions are torch.linalg's (cuSOLVER on the card). Those that are
unique only up to signs and order (`eig`, `svd`, `qr`, `eigh`, `lu`) may
pick other signs than the reference's LAPACK; what is unique agrees:
reconstructions, sorted eigenvalues, singular values, `lu_unpack`'s
product. `lstsq` is solved through the SVD on every device, so it returns
the reference's (solution, residuals, rank, singular values) on the card
too. Histograms bin as jnp.histogram does (searchsorted on edges from the
reference's linspace); counts are int64, as Paddle's.
"""

from __future__ import annotations

import builtins

import torch

from .math import _inexact, bmm, dot, matmul, mm

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "transpose_last2", "norm", "dist",
    "cond", "matrix_power", "matrix_rank", "det", "slogdet", "inv", "pinv",
    "solve", "triangular_solve", "cholesky", "cholesky_solve", "lu",
    "lu_unpack", "qr", "svd", "svdvals", "eig", "eigvals", "eigh",
    "eigvalsh", "lstsq", "multi_dot", "cross", "histogram", "histogramdd",
    "bincount", "mv", "corrcoef", "cov", "matrix_transpose",
    "householder_product", "pca_lowrank", "vecdot", "tensordot", "inverse",
]


def t(x, name=None):
    """The transpose of a 1-D or 2-D tensor; a higher one as it is."""
    return x.T if x.dim() <= 2 else x


def transpose_last2(x, name=None):
    return x.transpose(-1, -2)


matrix_transpose = transpose_last2


def _ord(p):
    if p == "inf":
        return float("inf")
    return p


def _flat_norm(a, p):
    return torch.linalg.vector_norm(a.reshape(-1), _ord(p))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Without axis: the 2-norm (p None or "fro") or p-norm of all
    elements, or the nuclear norm of a matrix; with two axes a matrix norm
    (Frobenius by default); with one a vector norm (2 by default)."""
    x = _inexact(x)
    if axis is None:
        if p is None or p == "fro":
            return _flat_norm(x, 2)
        if p == "nuc":
            return torch.linalg.matrix_norm(x, "nuc")
        return _flat_norm(x, p)
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, "fro" if p is None else _ord(p),
                                        tuple(axis), keepdim)
    ax = axis[0] if isinstance(axis, (list, tuple)) else axis
    return torch.linalg.vector_norm(x, 2 if p is None else _ord(p), ax,
                                    keepdim)


def dist(x, y, p=2, name=None):
    return _flat_norm(_inexact(x - y), p)


def cond(x, p=None, name=None):
    return torch.linalg.cond(x, _ord(p))


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """Singular values above `tol` (absolute), or above the largest times
    max(m, n) times the dtype's epsilon."""
    if tol is None:
        return torch.linalg.matrix_rank(x, hermitian=hermitian)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                    hermitian=hermitian)


def det(x, name=None):
    return torch.linalg.det(x)


def slogdet(x, name=None):
    """stack([sign, log|det|])."""
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


def inv(x, name=None):
    return torch.linalg.inv(x)


inverse = inv


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """X with x X = y (x^T X = y with `transpose`), x triangular."""
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """X with A X = x, where y is A's Cholesky factor."""
    return torch.cholesky_solve(x, y, upper=upper)


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 1-based int32 pivots[, infos])."""
    lu_, piv = torch.linalg.lu_factor(x)
    if get_infos:
        return lu_, piv, torch.zeros((), dtype=torch.int32, device=x.device)
    return lu_, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with P L U the matrix `lu` factored."""
    m, n = x.shape[-2:]
    lower = torch.tril(x, -1) + torch.eye(m, n, dtype=x.dtype,
                                          device=x.device)
    upper = torch.triu(x)
    perm = list(range(m))
    for i, j in enumerate(y.reshape(-1).tolist()):
        perm[i], perm[j - 1] = perm[j - 1], perm[i]
    p = torch.eye(m, dtype=x.dtype, device=x.device)[perm].T
    return p, lower, upper


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    """(U, S, V) with x = U diag(S) V^H: V, not V^H, as Paddle's."""
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mH


def svdvals(x, name=None):
    return torch.linalg.svdvals(x)


def eig(x, name=None):
    return torch.linalg.eig(x)


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigh(x, UPLO="L", name=None):
    return torch.linalg.eigh(x, UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) as jnp.linalg.lstsq
    computes them: singular values below rcond (default eps * max(m, n))
    times the largest are dropped, and the residuals are the squared
    2-norms of the columns of y - x @ solution, whatever the rank."""
    m, n = x.shape[-2:]
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * builtins.max(m, n)
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    sol = vh.mH @ (s_inv[..., None] * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=-2) ** 2
    rank = keep.sum(-1).to(torch.int32)
    return (sol[:, 0] if vec else sol), resid, rank, s


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


def cross(x, y, axis=9, name=None):
    """The cross product along `axis`; by default the first axis of
    size 3."""
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    x, y = torch.broadcast_tensors(x, y)
    return torch.linalg.cross(x, y, dim=axis)


def _linspace(lo, hi, num, dtype, device):
    """jnp.linspace's values: lo (1 - i/div) + hi (i/div), the last one
    exactly hi."""
    div = num - 1
    if div == 0:
        return torch.as_tensor(lo, dtype=dtype, device=device).reshape(1)
    step = torch.arange(div, dtype=dtype, device=device) / div
    return torch.cat([lo * (1 - step) + hi * step,
                      torch.as_tensor(hi, dtype=dtype,
                                      device=device).reshape(1)])


def _bin_edges(a, bins, lo=None, hi=None):
    """jnp.histogram_bin_edges: `bins` + 1 edges over [lo, hi] (the data's
    range without one), widened by 0.5 each way when the range is empty."""
    dtype = a.dtype
    if lo is None:
        lo, hi = a.min(), a.max()
    lo = torch.as_tensor(lo, dtype=dtype, device=a.device)
    hi = torch.as_tensor(hi, dtype=dtype, device=a.device)
    if bool(lo == hi):
        lo, hi = lo - 0.5, hi + 0.5
    return _linspace(lo, hi, int(bins) + 1, dtype, a.device)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """Counts (int64) of `input` in `bins` equal bins over [min, max] (the
    data's range when both are 0); weighted sums or densities (float) with
    `weight` or `density`."""
    a = _inexact(input).reshape(-1)
    lo, hi = (min, max) if (min != 0 or max != 0) else (None, None)
    edges = _bin_edges(a, bins, lo, hi)
    w = (torch.ones_like(a) if weight is None
         else weight.reshape(-1).to(a.dtype))
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], len(edges) - 1, idx)
    inside = idx < len(edges)
    counts = torch.zeros(len(edges), dtype=w.dtype, device=a.device)
    counts = counts.index_add(0, idx[inside], w[inside])[1:]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts if density or weight is not None else counts.to(
        torch.int64)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """(counts over a D-dimensional grid, [the edges of each dimension]).
    `ranges` is flat, [lo0, hi0, lo1, hi1, ...], as the reference's."""
    x = _inexact(x)
    d = x.shape[-1]
    sample = x.reshape(-1, d)
    bins = list(bins) if isinstance(bins, (list, tuple)) else [bins] * d
    flat = None if ranges is None else [float(r) for r in ranges]
    edges, idxs = [], []
    for i in range(d):
        lo, hi = (None, None) if flat is None else flat[2 * i:2 * i + 2]
        e = _bin_edges(sample[:, i], bins[i], lo, hi)
        idx = torch.searchsorted(e, sample[:, i].contiguous(), right=True)
        idx = torch.where(sample[:, i] == e[-1], idx - 1, idx)
        edges.append(e)
        idxs.append(idx)
    nbins = [len(e) + 1 for e in edges]
    flat_idx = torch.zeros_like(idxs[0])
    for idx, nb in zip(idxs, nbins):
        flat_idx = flat_idx * nb + idx.clamp(0, nb - 1)
    numel = 1
    for nb in nbins:
        numel *= nb
    w = None if weights is None else weights.reshape(-1).to(x.dtype)
    hist = torch.bincount(flat_idx, w, minlength=numel)
    hist = hist.reshape(nbins)[(slice(1, -1),) * d]
    if w is not None:
        hist = hist.to(x.dtype)
    if density:
        hist = hist.to(x.dtype)
        hist = hist / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return hist, edges


def bincount(x, weights=None, minlength=0, name=None):
    """Occurrences of each value 0..max(x) (at least `minlength` of
    them): int64, or sums of `weights` in their dtype."""
    out = torch.bincount(x, weights, minlength)
    return out if weights is None else out.to(weights.dtype)


def mv(x, vec, name=None):
    return x @ vec


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def householder_product(x, tau, name=None):
    """The first n columns of the product of the Householder reflectors
    I - tau_i v_i v_i^T stored below x's diagonal."""
    return torch.linalg.householder_product(x, tau)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """(U, S, V) of the q leading components of x (x less its column means
    with `center`), from an exact SVD as the reference's."""
    qq = q if q is not None else builtins.min(6, x.shape[-2], x.shape[-1])
    b = x - x.mean(-2, keepdim=True) if center else x
    u, s, vh = torch.linalg.svd(b, full_matrices=False)
    return u[..., :qq], s[..., :qq], vh.mT[..., :qq]


def vecdot(x, y, axis=-1, name=None):
    return (x * y).sum(axis)


def tensordot(x, y, axes=2, name=None):
    """Contract `axes` (a count, a pair of axes, or a pair of axis
    lists)."""
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        if axes and not isinstance(axes[0], (list, tuple)):
            axes = ([int(axes[0])], [int(axes[1])]) if len(axes) == 2 \
                else (list(axes), list(axes))
        else:
            axes = tuple([int(a) for a in ax] for ax in axes)
    return torch.tensordot(x, y, dims=axes)

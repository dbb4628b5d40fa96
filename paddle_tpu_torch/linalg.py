"""The paddle.linalg namespace. reference: paddle_tpu/linalg.py: the
linear-algebra functions of tensor/linalg.py, and the namespace's own
(`cholesky_inverse`, `matrix_norm`, `vector_norm`, `matrix_exp`,
`svd_lowrank`, `ormqr`)."""

from __future__ import annotations

import builtins

import torch

from .framework.random import get_generator
from .tensor.linalg import (cholesky, cholesky_solve, cond, corrcoef,  # noqa: F401
                            cov, det, eig, eigh, eigvals, eigvalsh,
                            householder_product, inv, lstsq, lu, lu_unpack,
                            matrix_power, matrix_rank, multi_dot, norm,
                            pca_lowrank, pinv, qr, slogdet, solve, svd,
                            svdvals, triangular_solve)

__all__ = [
    "cholesky", "cholesky_inverse", "norm", "matrix_norm", "vector_norm",
    "cond", "cov", "corrcoef", "inv", "eig", "eigvals", "multi_dot",
    "matrix_rank", "svd", "qr", "householder_product", "pca_lowrank",
    "svd_lowrank", "lu", "lu_unpack", "matrix_exp", "matrix_power", "det",
    "slogdet", "eigh", "eigvalsh", "pinv", "solve", "cholesky_solve",
    "triangular_solve", "lstsq", "ormqr",
]


def cholesky_inverse(x, upper=False, name=None):
    """The inverse of A from its Cholesky factor x (A = x x^T, or x^T x
    with `upper`)."""
    return torch.cholesky_inverse(x, upper=upper)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """"fro", "nuc", 1, -1, 2, -2, inf or -inf over the two axes."""
    if p not in ("fro", "nuc", 1, -1, 2, -2, float("inf"), float("-inf")):
        raise ValueError(f"unsupported matrix norm order {p!r}")
    return torch.linalg.matrix_norm(x, p, tuple(axis), keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """The p-norm along `axis`; over all elements without one (a keepdim
    result then has one dimension, as the reference's)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.linalg.vector_norm(x, p, axis, keepdim)


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(x)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """(U, S, V) of rank min(q, m, n) by subspace iteration on a Gaussian
    sketch (Halko et al.), of x - M when M is given; the sketch is drawn
    from the port's generator of x's device."""
    a = x - M if M is not None else x
    m, n = a.shape[-2:]
    k = builtins.min(q, m, n)
    omega = torch.randn(a.shape[:-2] + (n, k), dtype=a.dtype,
                        device=a.device, generator=get_generator(a.device))
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.mT @ y)
    qmat, _ = torch.linalg.qr(y)
    u_b, s, vh = torch.linalg.svd(qmat.mT @ a, full_matrices=False)
    return qmat @ u_b, s, vh.mT


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """`other` multiplied by the orthogonal Q of a QR factorization stored
    as Householder vectors x and factors tau (Q^T with `transpose`; from
    the right without `left`)."""
    return torch.ormqr(x, tau, other, left, transpose)

"""The paddle.linalg namespace. reference: paddle_tpu/linalg.py: the
linear-algebra functions of tensor/linalg.py, and the namespace's own
(`cholesky_inverse`, `matrix_norm`, `vector_norm`, `matrix_exp`,
`svd_lowrank`, `ormqr`)."""

from __future__ import annotations

import builtins

import torch

from .framework.dtypes import convert_dtype
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


# fp8 x fp8 products taken by each path, counted as they run: cuBLASLt's
# (torch._scaled_mm) on the card where its rules take the operands, else
# the float32 product of the upcast operands (the CPU's, and the card's
# otherwise)
FP8_GEMM_PATHS = {"scaled_mm": 0, "upcast": 0}
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _scaled_mm_f32(a, b):
    """cuBLASLt's fp8 product of 2-D a and b on the card, accumulated and
    returned in float32 at unit scales; None where _scaled_mm's rules
    refuse them (not 2-D, not fp8, both e5m2, a size not a multiple of
    16)."""
    if not (a.is_cuda and a.ndim == b.ndim == 2 and a.dtype in _FP8
            and b.dtype in _FP8
            and not a.dtype == b.dtype == torch.float8_e5m2
            and all(n % 16 == 0 for n in (*a.shape, b.shape[1]))):
        return None
    one = torch.ones((), dtype=torch.float32, device=a.device)
    out = torch._scaled_mm(a.contiguous(), b.t().contiguous().t(),
                           scale_a=one, scale_b=one, out_dtype=torch.float32)
    return out[0] if isinstance(out, tuple) else out


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, output_dtype="float16",
                            scale=1.0, activation_type="identity",
                            name=None):
    """act(scale * (x @ y) + bias) cast to `output_dtype`, for fp8 x and y
    (the last two axes transposed where asked): the product accumulated in
    float32, then the scale, the bias and gelu (tanh form, as the
    reference's jax.nn.gelu) or relu in float32. On the card the product
    is cuBLASLt's fp8 GEMM where torch._scaled_mm takes the operands,
    else the float32 product of the upcast operands, as on the CPU
    (FP8_GEMM_PATHS counts each)."""
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    out = _scaled_mm_f32(a, b)
    FP8_GEMM_PATHS["upcast" if out is None else "scaled_mm"] += 1
    if out is None:
        out = torch.matmul(a.float(), b.float())
    out = out * scale
    if bias is not None:
        out = out + bias.float()
    if activation_type == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    elif activation_type == "relu":
        out = torch.relu(out)
    return out.to(convert_dtype(output_dtype))

"""The port's tensor/linalg.py and paddle.linalg namespace (linalg.py)
against the reference's, one parametrised case per function.

Functions with a unique result are compared directly, at rtol 1e-4,
atol 1e-5 (LAPACK's float32 factorizations differ between the packages'
builds by a few ulps of the matrix). Decompositions unique only up to
signs and order are held to what is unique: `svd`'s singular values and
U S V^H, `qr`'s Q R and |R|, `eigh`'s sorted eigenvalues and V diag(w)
V^T, `eig`'s sorted eigenvalues and A V = V diag(w), `lu`'s P L U, the
low-rank SVDs' reconstructions."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_op_parity import A, run, to_np

TOL = dict(rtol=1e-4, atol=1e-5)
R = np.random.default_rng(2)
M = R.standard_normal((4, 4)).astype(np.float32)
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
L = np.linalg.cholesky(SPD).astype(np.float32)
TALL = R.standard_normal((6, 3)).astype(np.float32)
B = R.standard_normal((4, 2)).astype(np.float32)
B6 = R.standard_normal((6, 2)).astype(np.float32)
V4 = R.standard_normal(4).astype(np.float32)
X = R.standard_normal((3, 4)).astype(np.float32)
X3 = R.standard_normal((2, 3, 4)).astype(np.float32)
U3 = R.standard_normal((5, 3)).astype(np.float32)
I = R.integers(0, 6, 20).astype(np.int64)
H = (R.random(200) * 4 - 1).astype(np.float32)
PTS = R.standard_normal((50, 2)).astype(np.float32)
LOW = (R.standard_normal((8, 2)) @ R.standard_normal((2, 6))).astype(
    np.float32)
QR_A = np.linalg.qr(TALL, mode="raw")

CASES = [
    ("t", "t", [A(X)], {}),
    ("t_3d", "t", [A(X3)], {}),
    ("transpose_last2", "transpose_last2", [A(X3)], {}),
    ("matrix_transpose", "matrix_transpose", [A(X3)], {}),
    ("norm", "norm", [A(X)], {}),
    ("norm_fro", "norm", [A(X)], {"p": "fro"}),
    ("norm_nuc", "norm", [A(X)], {"p": "nuc"}),
    ("norm_p3", "norm", [A(X)], {"p": 3}),
    ("norm_inf", "norm", [A(X)], {"p": float("inf")}),
    ("norm_axis", "norm", [A(X)], {"p": 1, "axis": 1, "keepdim": True}),
    ("norm_matrix", "norm", [A(X3)], {"p": "fro", "axis": [1, 2]}),
    ("norm_matrix_1", "norm", [A(X3)], {"p": 1, "axis": [1, 2]}),
    ("dist", "dist", [A(X), A(X[::-1].copy())], {"p": 3}),
    ("cond", "cond", [A(SPD)], {}),
    ("matrix_power", "matrix_power", [A(M)], {"n": 3}),
    ("matrix_power_neg", "matrix_power", [A(SPD)], {"n": -2}),
    ("matrix_rank", "matrix_rank", [A(LOW)], {}),
    ("matrix_rank_tol", "matrix_rank", [A(M)], {"tol": 1.0}),
    ("det", "det", [A(M)], {}),
    ("slogdet", "slogdet", [A(M)], {}),
    ("inv", "inv", [A(SPD)], {}),
    ("inverse", "inverse", [A(SPD)], {}),
    ("pinv", "pinv", [A(TALL)], {}),
    ("solve", "solve", [A(SPD), A(B)], {}),
    ("solve_vec", "solve", [A(SPD), A(V4)], {}),
    ("triangular_solve", "triangular_solve", [A(L), A(B)],
     {"upper": False}),
    ("triangular_solve_t", "triangular_solve", [A(L.T.copy()), A(B)],
     {"transpose": True}),
    ("triangular_solve_unit", "triangular_solve", [A(L), A(B)],
     {"upper": False, "unitriangular": True}),
    ("cholesky", "cholesky", [A(SPD)], {}),
    ("cholesky_upper", "cholesky", [A(SPD)], {"upper": True}),
    ("cholesky_solve", "cholesky_solve", [A(B), A(L)], {}),
    ("cholesky_solve_upper", "cholesky_solve", [A(B), A(L.T.copy())],
     {"upper": True}),
    ("svdvals", "svdvals", [A(TALL)], {}),
    ("eigvalsh", "eigvalsh", [A(SPD)], {}),
    ("eigvalsh_upper", "eigvalsh", [A(SPD)], {"UPLO": "U"}),
    ("lstsq", "lstsq", [A(TALL), A(B6)], {}),
    ("lstsq_rank_deficient", "lstsq", [A(LOW), A(B6[:, :1].repeat(
        8 // 6 + 1, 0)[:8].copy())], {}),
    ("multi_dot", "multi_dot", [[A(X), A(M), A(M)]], {}),
    ("cross", "cross", [A(U3), A(U3[::-1].copy())], {}),
    ("cross_axis", "cross", [A(U3.T.copy()), A(U3.T[:, ::-1].copy())],
     {"axis": 0}),
    ("histogram", "histogram", [A(H)], {"bins": 7}),
    ("histogram_range", "histogram", [A(H)], {"bins": 5, "min": 0,
                                              "max": 2}),
    ("histogram_weight", "histogram", [A(H)],
     {"bins": 4, "weight": A(np.abs(H))}),
    ("histogram_density", "histogram", [A(H)],
     {"bins": 6, "density": True}),
    ("histogramdd", "histogramdd", [A(PTS)], {"bins": 3}),
    ("histogramdd_ranges", "histogramdd", [A(PTS)],
     {"bins": [2, 4], "ranges": [-1.0, 1.0, -2.0, 2.0]}),
    ("histogramdd_density", "histogramdd", [A(PTS)],
     {"bins": 3, "density": True, "weights": A(np.abs(PTS[:, 0]))}),
    ("bincount", "bincount", [A(I)], {}),
    ("bincount_weights", "bincount", [A(I)],
     {"weights": A(H[:20]), "minlength": 9}),
    ("mv", "mv", [A(M), A(V4)], {}),
    ("corrcoef", "corrcoef", [A(X)], {}),
    ("corrcoef_cols", "corrcoef", [A(TALL)], {"rowvar": False}),
    ("cov", "cov", [A(X)], {}),
    ("cov_biased_fweights", "cov", [A(X)],
     {"ddof": False, "fweights": A(np.array([1, 2, 1, 3]))}),
    ("cov_aweights", "cov", [A(TALL)],
     {"rowvar": False, "aweights": A(np.linspace(0.5, 2, 6).astype(
         np.float32))}),
    ("householder_product", "householder_product",
     [A(QR_A[0].T.copy().astype(np.float32)),
      A(QR_A[1].astype(np.float32))], {}),
    ("vecdot", "vecdot", [A(X), A(X[::-1].copy())], {}),
    ("tensordot", "tensordot", [A(X3), A(X.T.copy())], {"axes": 1}),
    ("tensordot_pair", "tensordot", [A(X3), A(X)], {"axes": [[1, 2],
                                                              [0, 1]]}),
    ("matmul", "matmul", [A(X), A(M)], {}),
    ("dot", "dot", [A(V4), A(V4)], {}),
    # the paddle.linalg namespace's own functions
    ("cholesky_inverse", "linalg.cholesky_inverse", [A(L)], {}),
    ("cholesky_inverse_upper", "linalg.cholesky_inverse", [A(L.T.copy())],
     {"upper": True}),
    ("matrix_norm", "linalg.matrix_norm", [A(X3)], {}),
    *[(f"matrix_norm_{p}", "linalg.matrix_norm", [A(X3)], {"p": p})
      for p in ("nuc", 1, -1, 2, -2, float("inf"), float("-inf"))],
    ("matrix_norm_keepdim", "linalg.matrix_norm", [A(X3)],
     {"p": 1, "axis": (0, 2), "keepdim": True}),
    ("vector_norm", "linalg.vector_norm", [A(X)], {}),
    ("vector_norm_keepdim", "linalg.vector_norm", [A(X)],
     {"p": 1.5, "keepdim": True}),
    ("vector_norm_axis", "linalg.vector_norm", [A(X)],
     {"p": float("inf"), "axis": 0}),
    ("vector_norm_0", "linalg.vector_norm", [A(np.round(X))],
     {"p": 0, "axis": 1}),
    ("matrix_exp", "linalg.matrix_exp", [A(M / 4)], {}),
    ("ormqr", "linalg.ormqr", [A(QR_A[0].T.copy().astype(np.float32)),
                               A(QR_A[1].astype(np.float32)),
                               A(B6)], {}),
    ("ormqr_t_right", "linalg.ormqr",
     [A(QR_A[0].T.copy().astype(np.float32)),
      A(QR_A[1].astype(np.float32)), A(B6.T.copy())],
     {"left": False, "transpose": True}),
    ("linalg_det", "linalg.det", [A(M)], {}),
    ("linalg_norm", "linalg.norm", [A(X)], {"p": 2, "axis": 1}),
]


@pytest.mark.parametrize("fn,args,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_linalg_matches_reference(fn, args, kwargs):
    run(fn, args, kwargs, tol=TOL)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _ref(x):
    return to_np(x)[0]


def test_svd_reconstructs():
    for full in (False, True):
        u, s, v = pt.svd(torch.tensor(TALL), full_matrices=full)
        _, rs, _ = paddle.svd(paddle.to_tensor(TALL), full_matrices=full)
        _close(s, _ref(rs))
        k = s.shape[0]
        _close(u[:, :k] @ torch.diag(s) @ v[:, :k].T, TALL)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_reconstructs(mode):
    out = pt.qr(torch.tensor(TALL), mode=mode)
    ref = paddle.qr(paddle.to_tensor(TALL), mode=mode)
    r, rr = (out, ref) if mode == "r" else (out[1], ref[1])
    _close(r.abs(), np.abs(_ref(rr)))
    if mode != "r":
        _close(out[0] @ out[1], TALL)
        _close(out[0].T @ out[0], np.eye(out[0].shape[1]))


def test_eigh_and_eig_unique_parts():
    w, v = pt.eigh(torch.tensor(SPD))
    rw, _ = paddle.eigh(paddle.to_tensor(SPD))
    _close(w, _ref(rw))
    _close(v @ torch.diag(w) @ v.T, SPD)
    w, v = pt.eig(torch.tensor(M))
    rw = _ref(paddle.eig(paddle.to_tensor(M))[0])
    key = lambda z: np.lexsort((np.round(z.imag, 4), np.round(z.real, 4)))
    wn = w.numpy()
    _close(wn[key(wn)], rw[key(rw)])
    _close((torch.tensor(M).to(v.dtype) @ v).numpy(),
           (v @ torch.diag(w)).numpy())
    ev = pt.eigvals(torch.tensor(M)).numpy()
    _close(ev[key(ev)], rw[key(rw)])


def test_lu_and_lu_unpack():
    lu, piv = pt.lu(torch.tensor(M))
    rlu, rpiv = paddle.lu(paddle.to_tensor(M))
    np.testing.assert_array_equal(piv.numpy(), _ref(rpiv))
    _close(lu, _ref(rlu))
    p, lo, up = pt.lu_unpack(lu, piv)
    rp, rl, ru = paddle.lu_unpack(rlu, rpiv)
    for a, b in ((p, rp), (lo, rl), (up, ru)):
        _close(a, _ref(b))
    _close(p @ lo @ up, M)
    assert len(pt.lu(torch.tensor(M), get_infos=True)) == 3


def test_low_rank_decompositions_reconstruct():
    x = torch.tensor(LOW)
    u, s, v = pt.pca_lowrank(x, q=2, center=False)
    _, rs, _ = paddle.pca_lowrank(paddle.to_tensor(LOW), q=2, center=False)
    _close(s, _ref(rs))
    _close(u @ torch.diag(s) @ v.T, LOW)
    u, s, v = pt.pca_lowrank(x, q=2)
    _, rs, _ = paddle.pca_lowrank(paddle.to_tensor(LOW), q=2)
    _close(s, _ref(rs))
    pt.seed(0)
    u, s, v = pt.linalg.svd_lowrank(x, q=3)
    _, rs, _ = paddle.linalg.svd_lowrank(paddle.to_tensor(LOW), q=3)
    _close(s[:2], _ref(rs)[:2])
    _close(u @ torch.diag(s) @ v.T, LOW)


def test_linalg_namespace_is_the_reference_surface():
    assert sorted(pt.linalg.__all__) == sorted(paddle.linalg.__all__)
    assert pt.linalg.svd is pt.tensor.linalg.svd

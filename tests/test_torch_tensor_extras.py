"""The port's tensor/extras.py against the reference's, one parametrised
case per function (all 28, exported at the top level), floats at rtol
1e-5, atol 1e-6 (tests/torch_op_parity.py)."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from torch_op_parity import A, run
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
R = np.random.default_rng(3)
X = R.standard_normal((3, 4)).astype(np.float32)
Y = R.standard_normal((5, 4)).astype(np.float32)
P = (R.random((3, 4)) * 3 + 0.5).astype(np.float32)
Q = (R.random((3, 4)) * 3 + 0.5).astype(np.float32)
V = R.standard_normal(3).astype(np.float32)
M = R.standard_normal((2, 2)).astype(np.float32)
I = R.integers(0, 5, (3, 4)).astype(np.int64)
C = (X + 1j * np.round(X)).astype(np.complex64)
MASK = X > 0

CASES = [
    ("add_n", "add_n", [[A(X), A(P), A(Q)]], {}),
    ("block_diag", "block_diag", [[A(M), A(V), A(X[:1])]], {}),
    ("broadcast_shape", "broadcast_shape", [[3, 1, 4], [5, 1]], {}),
    ("cartesian_prod", "cartesian_prod", [[A(V), A(V[:2].copy())]], {}),
    ("cdist", "cdist", [A(X), A(Y)], {}),
    ("cdist_same_rows", "cdist", [A(X), A(X)], {}),
    ("cdist_p1", "cdist", [A(X), A(Y)], {"p": 1.0}),
    ("cdist_inf", "cdist", [A(X), A(Y)], {"p": float("inf")}),
    ("cdist_p0", "cdist", [A(np.round(X)), A(np.round(Y))], {"p": 0}),
    ("combinations", "combinations", [A(V)], {}),
    ("combinations_replacement", "combinations", [A(V)],
     {"r": 3, "with_replacement": True}),
    ("diag_embed", "diag_embed", [A(X)], {}),
    ("diag_embed_offset", "diag_embed", [A(X)],
     {"offset": -1, "dim1": 0, "dim2": 2}),
    ("frexp", "frexp", [A(X * 100)], {}),
    ("gammainc", "gammainc", [A(P), A(Q)], {}),
    ("gammaincc", "gammaincc", [A(P), A(Q)], {}),
    ("gammaln", "gammaln", [A(P)], {}),
    ("histogram_bin_edges", "histogram_bin_edges", [A(X)], {"bins": 6}),
    ("histogram_bin_edges_range", "histogram_bin_edges", [A(X)],
     {"bins": 4, "min": -1, "max": 3}),
    ("index_fill", "index_fill", [A(X), A(np.array([0, 2])), 1, 9.0], {}),
    ("isin", "isin", [A(I), A(np.array([1, 3]))], {}),
    ("isin_invert", "isin", [A(I), A(np.array([1, 3]))], {"invert": True}),
    ("logcumsumexp", "logcumsumexp", [A(X)], {"axis": 1}),
    ("logcumsumexp_flat", "logcumsumexp", [A(X)], {}),
    ("masked_scatter", "masked_scatter",
     [A(X), A(MASK), A(np.arange(12, dtype=np.float32))], {}),
    ("masked_scatter_broadcast", "masked_scatter",
     [A(X), A(MASK[:1]), A(np.arange(12, dtype=np.float32))], {}),
    ("multigammaln", "multigammaln", [A(P + 2)], {"p": 3}),
    ("pdist", "pdist", [A(Y)], {}),
    ("pdist_p3", "pdist", [A(Y)], {"p": 3.0}),
    ("polygamma", "polygamma", [A(P)], {"n": 2}),
    ("reduce_as", "reduce_as", [A(np.stack([X, X])), A(X[:1])], {}),
    ("renorm", "renorm", [A(X)], {"p": 2.0, "axis": 0, "max_norm": 1.0}),
    ("renorm_inf", "renorm", [A(X)],
     {"p": float("inf"), "axis": 1, "max_norm": 0.5}),
    ("reverse", "reverse", [A(X)], {"axis": 1}),
    ("reverse_axes", "reverse", [A(X)], {"axis": [0, 1]}),
    ("sgn", "sgn", [A(np.round(X))], {}),
    ("sgn_complex", "sgn", [A(C)], {}),
    ("signbit", "signbit", [A(X)], {}),
    ("sinc", "sinc", [A(X)], {}),
    ("take", "take", [A(X), A(np.array([[0, 5], [11, -1]]))], {}),
    ("take_wrap", "take", [A(X), A(np.array([13, -14]))], {"mode": "wrap"}),
    ("take_clip", "take", [A(X), A(np.array([20, 3]))], {"mode": "clip"}),
    ("trace", "trace", [A(X)], {}),
    ("trace_offset", "trace", [A(np.stack([X, X]))],
     {"offset": 1, "axis1": 1, "axis2": 2}),
    ("vander", "vander", [A(V)], {}),
    ("vander_increasing", "vander", [A(V)], {"n": 4, "increasing": True}),
    ("as_strided", "as_strided", [A(X), [2, 3], [1, 4]], {"offset": 1}),
]


@pytest.mark.parametrize("fn,args,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_extras_match_reference(fn, args, kwargs):
    run(fn, args, kwargs, tol=TOL)


def test_every_extra_is_at_the_top_level():
    from paddle_tpu_torch.tensor import extras
    for name in extras.__all__:
        assert getattr(pt, name) is getattr(extras, name)
        assert name in pt.__all__


def test_extras_differentiate():
    x = torch.tensor(X, requires_grad=True)
    (pt.cdist(x, torch.tensor(Y)).sum() + pt.trace(x)
     + pt.logcumsumexp(x, axis=1).sum()).backward()
    assert torch.isfinite(x.grad).all()

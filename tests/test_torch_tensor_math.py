"""The port's tensor/math.py and the in-place family against the
reference's, one parametrised case per function (more where an argument
or a dtype changes the path). Inputs come from a numpy seed; the same
arrays go to both. Floats are held at rtol 1e-5, atol 1e-6 (the special
functions' float32 series differ between XLA's and torch's by a few ulps);
integers and bools exactly, dtypes by kind (tests/torch_op_parity.py)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_op_parity import A, run, same, to_np
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
R = np.random.default_rng(0)
X = R.standard_normal((3, 4)).astype(np.float32)
Y = R.standard_normal((3, 4)).astype(np.float32)
P = (R.random((3, 4)) * 2 + 0.1).astype(np.float32)        # > 0
U = (R.random((3, 4)) * 1.8 - 0.9).astype(np.float32)      # in (-1, 1)
G = (R.random((3, 4)) * 2 + 1.1).astype(np.float32)        # > 1
I = R.integers(1, 9, (3, 4)).astype(np.int64)
J = R.integers(1, 9, (3, 4)).astype(np.int64)
V = R.standard_normal(4).astype(np.float32)
W = R.standard_normal(5).astype(np.float32)
M = R.standard_normal((4, 4)).astype(np.float32)
X3 = R.standard_normal((2, 3, 4)).astype(np.float32)
B = X > 0
NANS = np.where(B, X, np.nan).astype(np.float32)
INFS = np.array([1.0, np.inf, -np.inf, np.nan, 0.0], np.float32)
C = (X + 1j * Y).astype(np.complex64)

UNARY = {
    "abs": X, "acos": U, "acosh": G, "asin": U, "asinh": X, "atan": X,
    "atanh": U, "ceil": X, "cos": X, "cosh": X, "digamma": P, "erf": X,
    "erfinv": U, "exp": X, "expm1": X, "floor": X, "frac": X, "i0": X,
    "i0e": X, "i1": X, "i1e": X, "lgamma": P, "log": P, "log10": P,
    "log1p": P, "log2": P, "neg": X, "reciprocal": P, "round": X * 3,
    "rsqrt": P, "sigmoid": X, "sign": X, "sin": X, "sinh": X, "sqrt": P,
    "square": X, "tan": U, "tanh": X, "trunc": X * 3, "angle": X,
    "conj": C, "real": C, "imag": C, "deg2rad": X, "rad2deg": X,
    "isfinite": INFS, "isinf": INFS, "isnan": INFS, "isneginf": INFS,
    "isposinf": INFS, "isreal": C,
}
BINARY = {
    "add": (X, Y), "subtract": (X, Y), "multiply": (X, Y), "divide": (X, P),
    "floor_divide": (X, P), "mod": (X, P), "remainder": (X, P),
    "floor_mod": (I, J), "pow": (P, X), "maximum": (X, Y),
    "minimum": (X, Y), "fmax": (NANS, Y), "fmin": (NANS, Y),
    "atan2": (X, Y), "logaddexp": (X, Y), "hypot": (X, Y),
    "copysign": (X, Y), "nextafter": (X, Y), "ldexp": (X, I),
    "gcd": (I, J), "lcm": (I, J), "heaviside": (X, Y), "inner": (X, Y),
    "outer": (V, W), "kron": (M[:2, :2], X),
}
REDUCTIONS = ["sum", "mean", "prod", "max", "min", "amax", "amin", "nansum",
              "nanmean", "all", "any", "logsumexp"]

CASES = (
    [(f"unary_{n}", n, [A(a)], {}) for n, a in UNARY.items()]
    + [(f"binary_{n}", n, [A(a), A(b)], {}) for n, (a, b) in BINARY.items()]
    + [(f"{n}_{tag}", n, [A(NANS if n.startswith("nan") else X)], kw)
       for n in REDUCTIONS
       for tag, kw in (("all", {}), ("axis", {"axis": 1, "keepdim": True}),
                       ("axes", {"axis": [0, 1]}))]
    + [
        # promotion: an int tensor with a float scalar, int / int, an int
        # tensor to a float power, a bool sum, an int mean
        ("promote_int_float_scalar", "add", [A(I), 1.5], {}),
        ("promote_int_div_int", "divide", [A(I), A(J)], {}),
        ("promote_int_pow_float", "pow", [A(I), 0.5], {}),
        ("promote_float_int_scalar", "multiply", [A(X), 3], {}),
        ("promote_scalar_first", "subtract", [2.0, A(X)], {}),
        ("promote_bool_sum", "sum", [A(B)], {}),
        ("promote_int_mean", "mean", [A(I)], {}),
        ("promote_int_exp", "exp", [A(I)], {}),
        ("promote_sum_dtype", "sum", [A(I)], {"dtype": "float32"}),
        ("logit", "logit", [A(P / 3)], {}),
        ("logit_eps", "logit", [A(U)], {"eps": 0.2}),
        ("scale", "scale", [A(X)], {"scale": 2.0, "bias": 0.5}),
        ("scale_before", "scale", [A(X)],
         {"scale": 2.0, "bias": 0.5, "bias_after_scale": False}),
        ("clip", "clip", [A(X)], {"min": -0.5, "max": 0.5}),
        ("clip_lo", "clip", [A(X)], {"min": 0.0}),
        ("lerp", "lerp", [A(X), A(Y), 0.7], {}),
        ("lerp_tensor", "lerp", [A(X), A(Y), A(P / 3)], {}),
        ("addmm", "addmm", [A(X), A(X), A(M)], {"beta": 0.5, "alpha": 2.0}),
        ("multiplex", "multiplex", [[A(X), A(Y)],
                                    A(np.array([[1], [0], [1]], np.int32))],
         {}),
        ("nan_to_num", "nan_to_num", [A(INFS)], {"nan": 1.0}),
        ("stanh", "stanh", [A(X)], {}),
        ("count_nonzero", "count_nonzero", [A(np.where(B, X, 0))],
         {"axis": 1}),
        ("cumsum", "cumsum", [A(X)], {"axis": 1}),
        ("cumsum_flat", "cumsum", [A(X)], {}),
        ("cumprod", "cumprod", [A(X)], {"dim": 0}),
        ("cummax", "cummax", [A(np.round(X))], {"axis": 1}),
        ("cummin", "cummin", [A(np.round(X))], {"axis": 0}),
        ("trapezoid", "trapezoid", [A(X)], {"dx": 0.5}),
        ("trapezoid_x", "trapezoid", [A(X)], {"x": A(np.cumsum(P, 1))}),
        ("cumulative_trapezoid", "cumulative_trapezoid", [A(X)], {}),
        ("cumulative_trapezoid_x", "cumulative_trapezoid", [A(X)],
         {"x": A(np.cumsum(P, 1))}),
        ("diff", "diff", [A(X)], {"axis": 1}),
        ("diff_prepend", "diff", [A(X)],
         {"n": 2, "axis": 0, "prepend": A(Y[:1])}),
        ("dot", "dot", [A(V), A(V[::-1].copy())], {}),
        ("dot_rows", "dot", [A(X), A(Y)], {}),
        ("isclose", "isclose", [A(X), A(X + 1e-7)], {}),
        ("allclose", "allclose", [A(X), A(X + 1e-3)], {}),
        ("equal_all", "equal_all", [A(X), A(X)], {}),
        ("accuracy", "accuracy", [A(X), A(np.array([[1], [0], [3]]))],
         {"k": 2}),
        ("matmul", "matmul", [A(X), A(M)], {"transpose_y": True}),
        ("bmm", "bmm", [A(X3), A(X3.transpose(0, 2, 1).copy())], {}),
    ])


@pytest.mark.parametrize("fn,args,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_math_matches_reference(fn, args, kwargs):
    run(fn, args, kwargs, tol=TOL)


def test_bf16_with_float32_and_a_python_float():
    """bf16 op float32 gives float32; bf16 op a Python float stays bf16,
    the float rounded to bf16 first as JAX's weak typing does."""
    xb = A(X, "bfloat16")
    run("multiply", [xb, A(Y)], {}, tol=TOL)
    run("add", [xb, 1.001], {}, tol=dict(rtol=0, atol=0))
    run("maximum", [xb, 0.1], {}, tol=dict(rtol=0, atol=0))


def test_increment_is_in_place():
    x = torch.tensor(X)
    assert pt.increment(x, 2.0) is x
    np.testing.assert_allclose(x.numpy(), X + 2.0)


# the in-place family: (function, extra arguments, x)
INPLACE = [("abs_", [], X), ("exp_", [], X), ("clip_", [-0.5, 0.5], X),
           ("add_", [A(Y)], X), ("lerp_", [A(Y), 0.3], X),
           ("scale_", [2.0, 1.0], X), ("cumsum_", [1], X),
           ("tril_", [], M), ("masked_fill_", [A(M > 0), 2.0], M),
           ("index_fill_", [A(np.array([0, 2])), 0, -1.0], X),
           ("renorm_", [2.0, 0, 1.0], X), ("sigmoid_", [], X),
           ("pow_", [2.0], X), ("floor_mod_", [A(J)], I)]


@pytest.mark.parametrize("fn,extra,x", INPLACE, ids=[c[0] for c in INPLACE])
def test_inplace_writes_into_its_argument(fn, extra, x):
    """f_(x, ...) is x itself, holding the reference's f_(x, ...); another
    view of x sees the new values."""
    xp = torch.tensor(x)
    alias = xp.view(-1)
    out = getattr(pt, fn)(xp, *[a if not hasattr(a, "a") else
                                torch.tensor(a.a) for a in extra])
    assert out is xp
    xr = paddle.to_tensor(x)
    getattr(paddle, fn)(xr, *[a if not hasattr(a, "a") else
                              paddle.to_tensor(a.a) for a in extra])
    same(to_np(xp), to_np(xr), TOL)
    np.testing.assert_array_equal(alias.numpy(), xp.numpy().reshape(-1))


def test_inplace_that_changes_dtype_or_shape_rebinds():
    """A comparison's bool, a cast and a transpose cannot be written into
    x's storage: x is rebound to the result, as the reference rebinds."""
    x = torch.tensor(X)
    assert pt.equal_(x, torch.tensor(X)) is x and x.dtype == torch.bool
    assert bool(x.all())
    x = torch.tensor(X)
    assert pt.cast_(x, "int64") is x and x.dtype == torch.int64
    x = torch.tensor(X)
    assert pt.t_(x) is x and tuple(x.shape) == (4, 3)
    x = torch.tensor(X)
    y = torch.tensor(Y)
    assert pt.where_(torch.tensor(B), x, y) is x
    np.testing.assert_array_equal(x.numpy(), np.where(B, X, Y))


def test_inplace_on_a_leaf_that_requires_grad_raises():
    """torch's refusal, kept: the reference rebinds instead."""
    x = torch.tensor(X, requires_grad=True)
    with pytest.raises(RuntimeError, match="leaf"):
        pt.abs_(x)
    with pytest.raises(RuntimeError, match="leaf"):
        pt.cast_(x, "int64")


def test_accuracy_is_exported_by_metric():
    assert pt.metric.accuracy is pt.tensor.math.accuracy

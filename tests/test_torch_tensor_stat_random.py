"""The port's tensor/stat.py and tensor/random.py against the reference's.

Statistics: one parametrised case per function and path, the same numpy
arrays to both, floats at rtol 1e-5, atol 1e-6 (tests/torch_op_parity.py);
`median`'s even count among them (the mean of the two middle values).

Random draws come from torch's generators, not JAX keys, so they are held
to the reference's supports, moments and shapes: each case draws with
both packages, asserts the same shape and dtype kind, the reference's
support, and means (and spreads) within 5 standard errors of the
distribution's over 20,000 draws."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_op_parity import A, run, to_np

TOL = dict(rtol=1e-5, atol=1e-6)
R = np.random.default_rng(1)
X = R.standard_normal((3, 4)).astype(np.float32)
X5 = R.standard_normal((2, 5)).astype(np.float32)
NANS = np.where(X > -0.5, X, np.nan).astype(np.float32)
I = R.integers(0, 9, (3, 4)).astype(np.int64)

STAT = [
    ("std", "std", [A(X)], {}),
    ("std_axis_biased", "std", [A(X)],
     {"axis": 1, "unbiased": False, "keepdim": True}),
    ("var", "var", [A(X)], {"axis": [0, 1]}),
    ("var_int", "var", [A(I)], {"axis": 0}),
    ("median_even_all", "median", [A(X)], {}),
    ("median_even_axis", "median", [A(X)], {"axis": 1}),
    ("median_odd_axis_keepdim", "median", [A(X5)],
     {"axis": 1, "keepdim": True}),
    ("median_min", "median", [A(X)], {"axis": 1, "mode": "min"}),
    ("median_min_all", "median", [A(X5)], {"mode": "min"}),
    ("nanmedian", "nanmedian", [A(NANS)], {"axis": 1}),
    ("nanmedian_all", "nanmedian", [A(NANS)], {}),
    ("quantile", "quantile", [A(X)], {"q": 0.3, "axis": 1}),
    ("quantile_list", "quantile", [A(X)], {"q": [0.1, 0.5, 0.9]}),
    ("quantile_keepdim", "quantile", [A(X)],
     {"q": [0.25, 0.75], "axis": 0, "keepdim": True}),
    ("quantile_axes", "quantile", [A(X)], {"q": 0.6, "axis": [0, 1]}),
    *[(f"quantile_{m}", "quantile", [A(X)],
       {"q": 0.5, "axis": 1, "interpolation": m})
      for m in ("lower", "higher", "midpoint", "nearest")],
    ("nanquantile", "nanquantile", [A(NANS)], {"q": 0.4, "axis": 1}),
    ("nanquantile_nearest", "nanquantile", [A(NANS)],
     {"q": [0.5], "axis": 0, "interpolation": "nearest"}),
    ("mean", "mean", [A(X)], {"axis": 0}),
    ("numel", "numel", [A(X)], {}),
]


@pytest.mark.parametrize("fn,args,kwargs", [c[1:] for c in STAT],
                         ids=[c[0] for c in STAT])
def test_stat_matches_reference(fn, args, kwargs):
    run(fn, args, kwargs, tol=TOL)


def test_median_even_count_is_the_mean_of_the_middle_two():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(pt.median(x)) == 2.5
    assert float(torch.median(x)) == 2.0


N = 20000


def _mean_close(v, mean, std):
    got = float(np.mean(v))
    assert abs(got - mean) <= 5 * std / math.sqrt(v.size), (got, mean)


def _check(p, r, support=None, mean=None, std=None):
    pv, _ = to_np(p)
    rv, _ = to_np(r)
    assert pv.shape == rv.shape and pv.dtype.kind == rv.dtype.kind, (
        pv.shape, rv.shape, pv.dtype, rv.dtype)
    if support is not None:
        assert support(pv).all() and support(rv).all()
    if mean is not None:
        _mean_close(pv.astype(np.float64), mean, std)
        _mean_close(rv.astype(np.float64), mean, std)
    if std is not None and pv.size > 1000:
        assert abs(pv.std() - std) < 0.05 * std


def _both(fn, *args, **kw):
    """(port draw on the CPU, reference draw)."""
    port_kw = kw.pop("_port", {})
    p = fn(pt)(*[a(True) if callable(a) else a for a in args], **kw,
               **port_kw)
    r = fn(paddle)(*[a(False) if callable(a) else a for a in args], **kw)
    return p, r


def T(a, dtype=None):
    """An argument made as each package's tensor."""
    return lambda port: (torch.tensor(a) if port
                         else paddle.to_tensor(a, dtype=dtype))


CPU = {"_port": {"device": "cpu"}}
ONES = np.ones(N, np.float32)
RANDOM = [
    ("rand", lambda P: P.rand, [[N]], CPU,
     dict(support=lambda v: (v >= 0) & (v < 1), mean=0.5,
          std=math.sqrt(1 / 12))),
    ("randn", lambda P: P.randn, [[N]], CPU, dict(mean=0.0, std=1.0)),
    ("standard_normal", lambda P: P.standard_normal, [[N]], CPU,
     dict(mean=0.0, std=1.0)),
    ("normal", lambda P: P.normal, [1.0, 2.0, [N]], CPU,
     dict(mean=1.0, std=2.0)),
    ("normal_tensor_mean", lambda P: P.normal, [T(ONES * 3)], {},
     dict(mean=3.0, std=1.0)),
    ("uniform", lambda P: P.uniform, [[N]], dict(min=2.0, max=4.0, **CPU),
     dict(support=lambda v: (v >= 2) & (v < 4), mean=3.0,
          std=2 / math.sqrt(12))),
    ("randint", lambda P: P.randint, [3, 10, [N]], CPU,
     dict(support=lambda v: (v >= 3) & (v < 10), mean=6.0, std=2.0)),
    ("randint_like", lambda P: P.randint_like, [T(ONES), 0, 4], {},
     dict(support=lambda v: (v >= 0) & (v < 4), mean=1.5,
          std=math.sqrt(1.25))),
    ("randperm", lambda P: P.randperm, [50], CPU,
     dict(support=lambda v: np.sort(v) == np.arange(50))),
    ("bernoulli", lambda P: P.bernoulli, [T(ONES * 0.3)], {},
     dict(support=lambda v: (v == 0) | (v == 1), mean=0.3,
          std=math.sqrt(0.21))),
    ("poisson", lambda P: P.poisson, [T(ONES * 4)], {},
     dict(support=lambda v: v == np.round(v), mean=4.0, std=2.0)),
    ("standard_gamma", lambda P: P.standard_gamma, [T(ONES * 2)], {},
     dict(support=lambda v: v > 0, mean=2.0, std=math.sqrt(2))),
    ("binomial", lambda P: P.binomial, [T(ONES * 10), T(ONES * 0.4)], {},
     dict(support=lambda v: (v >= 0) & (v <= 10), mean=4.0,
          std=math.sqrt(2.4))),
    ("log_normal", lambda P: P.log_normal, [0.0, 0.5, [N]], CPU,
     dict(support=lambda v: v > 0, mean=math.exp(0.125),
          std=math.sqrt((math.exp(0.25) - 1) * math.exp(0.25)))),
    ("multinomial", lambda P: P.multinomial,
     [T(np.array([[0.1, 0.2, 0.7]] * 4, np.float32)), 2], {},
     dict(support=lambda v: (v >= 0) & (v < 3))),
    ("multinomial_replacement", lambda P: P.multinomial,
     [T(np.array([0.2, 0.8], np.float32)), N], dict(replacement=True),
     dict(support=lambda v: (v >= 0) & (v < 2), mean=0.8, std=0.4)),
]


@pytest.mark.parametrize("fn,args,kw,check", [c[1:] for c in RANDOM],
                         ids=[c[0] for c in RANDOM])
def test_random_matches_reference_distribution(fn, args, kw, check):
    pt.seed(0)
    p, r = _both(fn, *args, **dict(kw))
    _check(p, r, **check)


# the in-place fillers: (name, arguments, support, mean, std)
FILLERS = [
    ("normal_", [1.0, 0.5], None, 1.0, 0.5),
    ("uniform_", [-2.0, 2.0], lambda v: (v >= -2) & (v < 2), 0.0,
     4 / math.sqrt(12)),
    ("bernoulli_", [0.25], lambda v: (v == 0) | (v == 1), 0.25,
     math.sqrt(0.1875)),
    ("exponential_", [2.0], lambda v: v >= 0, 0.5, 0.5),
    ("log_normal_", [0.0, 0.5], lambda v: v > 0, math.exp(0.125),
     math.sqrt((math.exp(0.25) - 1) * math.exp(0.25))),
    ("geometric_", [0.25], lambda v: (v >= 1) & (v == np.round(v)), 4.0,
     math.sqrt(0.75) / 0.25),
    ("cauchy_", [0.0, 1.0], None, None, None),
]


@pytest.mark.parametrize("fn,args,support,mean,std", FILLERS,
                         ids=[c[0] for c in FILLERS])
def test_inplace_fillers(fn, args, support, mean, std):
    pt.seed(0)
    x = torch.zeros(N, requires_grad=True)
    assert getattr(pt, fn)(x, *args) is x
    xr = paddle.to_tensor(np.zeros(N, np.float32))
    getattr(paddle, fn)(xr, *args)
    _check(x, xr, support=support, mean=mean, std=std)
    if fn == "cauchy_":      # the median of Cauchy(0, 1) is 0
        assert abs(float(x.median())) < 0.05


def test_gumbel_softmax():
    logits = np.log(np.array([[0.1, 0.6, 0.3]] * N, np.float32))
    pt.seed(0)
    soft = pt.gumbel_softmax(torch.tensor(logits), temperature=0.5)
    ref = paddle.gumbel_softmax(paddle.to_tensor(logits), temperature=0.5)
    _check(soft, ref, support=lambda v: (v >= 0) & (v <= 1))
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-5)
    x = torch.tensor(logits[:8], requires_grad=True)
    hard = pt.nn.functional.gumbel_softmax(x, hard=True)
    assert set(hard.detach().unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(hard.detach().sum(-1).numpy(), 1.0)
    (hard * torch.arange(3.0)).sum().backward()      # straight-through
    assert x.grad.abs().sum() > 0
    # the category frequencies follow softmax(logits)
    freq = np.bincount(soft.argmax(-1).numpy(), minlength=3) / N
    np.testing.assert_allclose(freq, [0.1, 0.6, 0.3], atol=0.02)


def test_seed_repeats_draws_and_uniform_seed():
    pt.seed(7)
    a = pt.randn([5], device="cpu")
    pt.seed(7)
    np.testing.assert_array_equal(a.numpy(), pt.randn([5], device="cpu"))
    u1 = pt.uniform([4], seed=3, device="cpu")
    np.testing.assert_array_equal(u1.numpy(),
                                  pt.uniform([4], seed=3, device="cpu"))

"""The port's distribution against the JAX package's, on the CPU in float32,
parameters and values drawn by numpy from a seed: every distribution's
mean, variance, log_prob, prob, entropy and cdf/icdf where it has them,
the KL divergences of the registry (and the exponential-family Bregman
fallback against the closed forms), the transforms, Independent and
TransformedDistribution. Draws come from the port's generator, so they
are held to their support and moments over many samples (mean within
five standard errors), not to the reference's bits; rsample's gradient
reaches the parameters.

Tolerances: float32 rtol 1e-5, atol 1e-5 for closed forms (lgamma,
digamma and erf from torch against jax.scipy: a few ulps); 1e-4 for the
series and Monte-Carlo-free sums (Binomial's and Poisson's entropies, the
Bregman KL, whose gradient comes from autograd on each side).
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_seq_parity import ref_np

TOL = dict(rtol=1e-5, atol=1e-5)
SERIES = dict(rtol=1e-4, atol=1e-4)
D, JD = pt.distribution, paddle.distribution

_R = np.random.RandomState(0)


def _pos(*shape, lo=0.5, hi=2.5):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def _unit(*shape):
    return _R.uniform(0.1, 0.9, shape).astype(np.float32)


def _port_args(args):
    return [torch.tensor(a) if isinstance(a, (np.ndarray, np.generic))
            else a for a in args]


# name, constructor args, a value in the support, methods compared
CASES = [
    ("Normal", (_R.randn(3).astype(np.float32), _pos(3)),
     _R.randn(3).astype(np.float32),
     ["mean", "variance", "stddev", "log_prob", "prob", "entropy", "cdf"]),
    ("LogNormal", (_R.randn(3).astype(np.float32), _pos(3)), _pos(3),
     ["mean", "variance", "log_prob", "entropy"]),
    ("Uniform", (np.float32([0.0, -1.0, 2.0]), np.float32([1.0, 3.0, 2.5])),
     np.float32([0.3, 4.0, 2.2]),
     ["mean", "variance", "log_prob", "entropy", "cdf"]),
    ("Beta", (_pos(3), _pos(3)), _unit(3),
     ["mean", "variance", "log_prob", "entropy"]),
    ("Gamma", (_pos(3), _pos(3)), _pos(3),
     ["mean", "variance", "log_prob", "entropy"]),
    ("Chi2", (_pos(3, lo=1, hi=5),), _pos(3),
     ["mean", "variance", "log_prob", "entropy"]),
    ("Exponential", (_pos(3),), _pos(3),
     ["mean", "variance", "log_prob", "entropy", "cdf"]),
    ("Cauchy", (_R.randn(3).astype(np.float32), _pos(3)),
     _R.randn(3).astype(np.float32), ["log_prob", "entropy", "cdf"]),
    ("Gumbel", (_R.randn(3).astype(np.float32), _pos(3)),
     _R.randn(3).astype(np.float32),
     ["mean", "variance", "stddev", "log_prob", "entropy", "cdf"]),
    ("Laplace", (_R.randn(3).astype(np.float32), _pos(3)),
     _R.randn(3).astype(np.float32),
     ["mean", "variance", "stddev", "log_prob", "entropy", "cdf"]),
    ("StudentT", (np.float32([0.8, 1.5, 5.0]), _R.randn(3).astype(
        np.float32), _pos(3)), _R.randn(3).astype(np.float32),
     ["mean", "variance", "log_prob", "entropy"]),
    ("ContinuousBernoulli", (np.float32([0.2, 0.5, 0.8]),), _unit(3),
     ["mean", "variance", "log_prob", "entropy", "cdf"]),
    ("Bernoulli", (_unit(3),), np.float32([0, 1, 1]),
     ["mean", "variance", "log_prob", "entropy", "cdf"]),
    ("Binomial", (np.array([5, 8, 3]), _unit(3)), np.float32([2, 8, 0]),
     ["mean", "variance", "log_prob", "entropy"]),
    ("Categorical", (_R.randn(2, 4).astype(np.float32),), np.array([3, 0]),
     ["log_prob", "probs", "entropy"]),
    ("Geometric", (_unit(3),), np.float32([0, 3, 1]),
     ["mean", "variance", "stddev", "log_prob", "entropy", "cdf"]),
    ("Multinomial", (6, _pos(2, 4)), np.float32([[1, 2, 0, 3],
                                                 [6, 0, 0, 0]]),
     ["mean", "variance", "log_prob"]),
    ("Poisson", (_pos(3, lo=0.5, hi=6),), np.float32([0, 2, 7]),
     ["mean", "variance", "log_prob", "entropy"]),
    ("Dirichlet", (_pos(2, 3),), np.float32([[0.2, 0.3, 0.5],
                                             [0.6, 0.1, 0.3]]),
     ["mean", "variance", "log_prob", "entropy"]),
    ("LKJCholesky", (3, np.float32(1.7)),
     np.linalg.cholesky(np.float32([[1, 0.3, 0.1], [0.3, 1, -0.2],
                                    [0.1, -0.2, 1]])).astype(np.float32),
     ["log_prob"]),
]
APPROX = {("Binomial", "entropy"), ("Poisson", "entropy")}


def _pair(name, args):
    return getattr(D, name)(*_port_args(args)), getattr(JD, name)(*args)


@pytest.mark.parametrize("name,args,value,methods", CASES,
                         ids=[c[0] for c in CASES])
def test_distribution_matches_reference(name, args, value, methods):
    port, ref = _pair(name, args)
    assert tuple(port.batch_shape) == tuple(ref.batch_shape)
    assert tuple(port.event_shape) == tuple(ref.event_shape)
    for m in methods:
        attr_p, attr_r = getattr(port, m), getattr(ref, m)
        if m == "entropy":
            got, want = attr_p(), attr_r()
        elif callable(attr_p):
            got = attr_p(torch.tensor(value))
            want = attr_r(paddle.to_tensor(value))
        else:
            got, want = attr_p, attr_r
        tol = SERIES if (name, m) in APPROX else TOL
        np.testing.assert_allclose(got.detach().numpy(), ref_np(want),
                                   err_msg=f"{name}.{m}", **tol)


@pytest.mark.parametrize("name,args,probs", [
    ("Normal", (np.float32([0.0, 1.0]), np.float32([1.0, 2.0])),
     np.float32([0.1, 0.7])),
    ("Laplace", (np.float32([0.0, 1.0]), np.float32([1.0, 2.0])),
     np.float32([0.2, 0.9])),
])
def test_icdf_inverts_cdf(name, args, probs):
    port, ref = _pair(name, args)
    got = port.icdf(torch.tensor(probs))
    np.testing.assert_allclose(got.numpy(),
                               ref_np(ref.icdf(paddle.to_tensor(probs))),
                               **TOL)
    np.testing.assert_allclose(port.cdf(got).numpy(), probs, **TOL)


N = 20000
# name, args, support (low, high), mean, variance
SAMPLES = [
    ("Normal", (1.0, 2.0), None, 1.0, 4.0),
    ("LogNormal", (0.0, 0.5), (0, math.inf), math.exp(0.125),
     (math.exp(0.25) - 1) * math.exp(0.25)),
    ("Uniform", (2.0, 4.0), (2, 4), 3.0, 4 / 12),
    ("Beta", (2.0, 3.0), (0, 1), 0.4, 6 / (25 * 6)),
    ("Gamma", (3.0, 2.0), (0, math.inf), 1.5, 0.75),
    ("Chi2", (4.0,), (0, math.inf), 4.0, 8.0),
    ("Exponential", (2.0,), (0, math.inf), 0.5, 0.25),
    ("Gumbel", (1.0, 2.0), None, 1.0 + 2 * 0.5772156649,
     math.pi ** 2 / 6 * 4),
    ("Laplace", (1.0, 2.0), None, 1.0, 8.0),
    ("StudentT", (6.0, 1.0, 2.0), None, 1.0, 4 * 6 / 4),
    ("ContinuousBernoulli", (0.3,), (0, 1), None, None),
    ("Bernoulli", (0.3,), (0, 1), 0.3, 0.21),
    ("Binomial", (10, 0.4), (0, 10), 4.0, 2.4),
    ("Geometric", (0.25,), (0, math.inf), 3.0, 12.0),
    ("Poisson", (4.0,), (0, math.inf), 4.0, 4.0),
]


@pytest.mark.parametrize("name,args,support,mean,var", SAMPLES,
                         ids=[s[0] for s in SAMPLES])
def test_samples_by_support_and_moments(name, args, support, mean, var):
    pt.seed(0)
    dist = getattr(D, name)(*args, device="cpu")
    s = dist.sample([N]).double()
    assert s.shape == (N,) and torch.isfinite(s).all()
    if support is not None:
        assert (s >= support[0]).all() and (s <= support[1]).all()
    if mean is None:
        mean, var = float(dist.mean), float(dist.variance)
    assert abs(float(s.mean()) - mean) <= 5 * math.sqrt(var / N), name
    assert abs(float(s.var()) - var) <= 0.1 * var, name
    pt.seed(0)
    torch.testing.assert_close(getattr(D, name)(*args, device="cpu")
                               .sample([N]).double(), s)


def test_cauchy_categorical_multinomial_dirichlet_mvn_lkj_samples():
    pt.seed(1)
    c = D.Cauchy(0.0, 1.0, device="cpu").sample([N])
    assert abs(float(c.median())) < 0.05
    cat = D.Categorical(torch.log(torch.tensor([0.2, 0.5, 0.3]))).sample(
        [N])
    freq = torch.bincount(cat, minlength=3).double() / N
    torch.testing.assert_close(freq, torch.tensor([0.2, 0.5, 0.3],
                                                  dtype=torch.float64),
                               atol=0.02, rtol=0)
    assert D.Categorical(torch.zeros(2, 5)).sample([7]).shape == (7, 2)
    m = D.Multinomial(6, torch.tensor([1.0, 2.0, 3.0])).sample([N])
    assert (m.sum(-1) == 6).all()
    torch.testing.assert_close(m.mean(0), torch.tensor([1.0, 2.0, 3.0]),
                               atol=0.05, rtol=0)
    dr = D.Dirichlet(torch.tensor([2.0, 3.0, 5.0])).sample([N])
    torch.testing.assert_close(dr.sum(-1), torch.ones(N))
    torch.testing.assert_close(dr.mean(0), torch.tensor([0.2, 0.3, 0.5]),
                               atol=0.01, rtol=0)
    cov = torch.tensor([[2.0, 0.6], [0.6, 1.0]])
    mv = D.MultivariateNormal(torch.tensor([1.0, -1.0]),
                              covariance_matrix=cov).sample([N])
    torch.testing.assert_close(torch.cov(mv.T), cov, atol=0.08, rtol=0)
    lkj = D.LKJCholesky(4, 2.0, device="cpu").sample([50])
    corr = lkj @ lkj.transpose(-1, -2)
    torch.testing.assert_close(torch.diagonal(corr, dim1=-2, dim2=-1),
                               torch.ones(50, 4))
    assert (torch.triu(lkj, 1) == 0).all()


def test_rsample_gradient_reaches_parameters():
    loc = torch.tensor([0.5], requires_grad=True)
    scale = torch.tensor([2.0], requires_grad=True)
    pt.seed(2)
    x = D.Normal(loc, scale).rsample([64])
    x.sum().backward()
    assert loc.grad.item() == pytest.approx(64.0)
    conc = torch.tensor([2.0], requires_grad=True)
    D.Gamma(conc, torch.tensor([1.0])).rsample([16]).sum().backward()
    assert conc.grad is not None and torch.isfinite(conc.grad).all()
    assert not D.Normal(loc, scale).sample([3]).requires_grad


def test_multivariate_normal_parametrisations():
    loc = np.float32([0.5, -1.0, 2.0])
    a = _R.randn(3, 3).astype(np.float32)
    cov = (a @ a.T + 3 * np.eye(3)).astype(np.float32)
    v = _R.randn(2, 3).astype(np.float32)
    ref = JD.MultivariateNormal(loc, covariance_matrix=cov)
    for kw in (dict(covariance_matrix=cov),
               dict(precision_matrix=np.linalg.inv(cov).astype(np.float32)),
               dict(scale_tril=np.linalg.cholesky(cov).astype(np.float32))):
        port = D.MultivariateNormal(torch.tensor(loc), **{
            k: torch.tensor(x) for k, x in kw.items()})
        np.testing.assert_allclose(port.log_prob(torch.tensor(v)).numpy(),
                                   ref_np(ref.log_prob(paddle.to_tensor(v))),
                                   rtol=1e-4, atol=1e-4)
        for m in ("entropy",):
            np.testing.assert_allclose(getattr(port, m)().numpy(),
                                       ref_np(getattr(ref, m)()), **TOL)
        for m in ("mean", "variance", "covariance_matrix"):
            np.testing.assert_allclose(getattr(port, m).numpy(),
                                       ref_np(getattr(ref, m)), rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError, match="Exactly one"):
        D.MultivariateNormal(torch.tensor(loc))


KL = [
    ("Normal", (np.float32([0.0, 1.0]), np.float32([1.0, 2.0])),
     (np.float32([0.5, 0.0]), np.float32([1.5, 1.0]))),
    ("LogNormal", (np.float32([0.0]), np.float32([1.0])),
     (np.float32([0.3]), np.float32([0.5]))),
    ("Uniform", (np.float32([0.0, 0.0]), np.float32([1.0, 2.0])),
     (np.float32([-1.0, 0.5]), np.float32([2.0, 3.0]))),
    ("Beta", (_pos(2), _pos(2)), (_pos(2), _pos(2))),
    ("Gamma", (_pos(2), _pos(2)), (_pos(2), _pos(2))),
    ("Exponential", (_pos(2),), (_pos(2),)),
    ("Cauchy", (np.float32([0.0]), np.float32([1.0])),
     (np.float32([1.0]), np.float32([2.0]))),
    ("Laplace", (np.float32([0.0]), np.float32([1.0])),
     (np.float32([1.0]), np.float32([2.0]))),
    ("ContinuousBernoulli", (np.float32([0.2, 0.7]),),
     (np.float32([0.6, 0.4]),)),
    ("Bernoulli", (_unit(2),), (_unit(2),)),
    ("Binomial", (np.array([4, 4]), _unit(2)), (np.array([4, 4]), _unit(2))),
    ("Categorical", (_R.randn(2, 3).astype(np.float32),),
     (_R.randn(2, 3).astype(np.float32),)),
    ("Geometric", (_unit(2),), (_unit(2),)),
    ("Poisson", (_pos(2),), (_pos(2),)),
    ("Dirichlet", (_pos(3),), (_pos(3),)),
    ("Chi2", (_pos(2, lo=1, hi=4),), (_pos(2, lo=1, hi=4),)),
]


@pytest.mark.parametrize("name,p_args,q_args", KL, ids=[k[0] for k in KL])
def test_kl_divergence(name, p_args, q_args):
    (p, rp), (q, rq) = _pair(name, p_args), _pair(name, q_args)
    want = ref_np(JD.kl_divergence(rp, rq))
    np.testing.assert_allclose(D.kl_divergence(p, q).numpy(), want, **TOL)
    np.testing.assert_allclose(p.kl_divergence(q).numpy(), want, **TOL)


def test_mvn_kl_and_bregman_fallback():
    a = _R.randn(3, 3).astype(np.float32)
    c1 = (a @ a.T + 2 * np.eye(3)).astype(np.float32)
    c2 = (np.eye(3) * 1.5).astype(np.float32)
    l1, l2 = np.float32([0, 1, 2]), np.float32([1, 1, 0])
    p = D.MultivariateNormal(torch.tensor(l1),
                             covariance_matrix=torch.tensor(c1))
    q = D.MultivariateNormal(torch.tensor(l2),
                             covariance_matrix=torch.tensor(c2))
    want = JD.kl_divergence(JD.MultivariateNormal(l1, covariance_matrix=c1),
                            JD.MultivariateNormal(l2, covariance_matrix=c2))
    np.testing.assert_allclose(D.kl_divergence(p, q).numpy(), ref_np(want),
                               rtol=1e-4, atol=1e-4)
    from paddle_tpu.distribution.kl import _kl_expfamily_expfamily as jbreg
    from paddle_tpu_torch.distribution.kl import _kl_expfamily_expfamily
    for name, pa, qa in (KL[0], KL[3], KL[4], KL[9], KL[13]):
        (p, rp), (q, rq) = _pair(name, pa), _pair(name, qa)
        got = _kl_expfamily_expfamily(p, q)
        np.testing.assert_allclose(got.numpy(), ref_np(jbreg(rp, rq)),
                                   **SERIES)
        np.testing.assert_allclose(got.numpy(),
                                   D.kl_divergence(p, q).numpy(), **SERIES)


def test_register_kl_dispatch_and_exp_family_entropy():
    class MyNormal(D.Normal):
        pass

    p = MyNormal(torch.tensor(0.0), torch.tensor(1.0))
    q = D.Normal(torch.tensor(1.0), torch.tensor(2.0))
    # the most derived registration wins
    D.register_kl(MyNormal, D.Normal)(lambda a, b: torch.tensor(-7.0))
    try:
        assert float(D.kl_divergence(p, q)) == -7.0
    finally:
        from paddle_tpu_torch.distribution import kl
        del kl._REGISTRY[(MyNormal, D.Normal)]
    assert float(D.kl_divergence(p, q)) == pytest.approx(float(
        D.kl_divergence(D.Normal(torch.tensor(0.0), torch.tensor(1.0)), q)))
    with pytest.raises(NotImplementedError, match="register_kl"):
        D.kl_divergence(D.Cauchy(0.0, 1.0, device="cpu"), q)
    # the Bregman entropy of the base class against the closed form
    n = D.Normal(torch.tensor([0.0, 1.0]), torch.tensor([1.0, 3.0]))
    torch.testing.assert_close(D.ExponentialFamily.entropy(n), n.entropy())
    e = D.Exponential(torch.tensor([0.5, 2.0]))
    torch.testing.assert_close(D.ExponentialFamily.entropy(e), e.entropy())


TRANSFORMS = [
    ("AbsTransform", ()), ("AffineTransform", (np.float32(0.5),
                                               np.float32(-2.0))),
    ("ExpTransform", ()), ("PowerTransform", (np.float32(3.0),)),
    ("SigmoidTransform", ()), ("TanhTransform", ()),
]


@pytest.mark.parametrize("name,args", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_reference(name, args):
    x = _unit(2, 3)
    port = getattr(D, name)(*_port_args(args))
    ref = getattr(JD, name)(*args)
    y = port.forward(torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), ref_np(ref.forward(
        paddle.to_tensor(x))), **TOL)
    np.testing.assert_allclose(port.inverse(y).numpy(), ref_np(
        ref.inverse(paddle.to_tensor(ref_np(ref.forward(
            paddle.to_tensor(x)))))), **TOL)
    np.testing.assert_allclose(
        port.forward_log_det_jacobian(torch.tensor(x)).numpy(),
        ref_np(ref.forward_log_det_jacobian(paddle.to_tensor(x))), **TOL)
    np.testing.assert_allclose(
        port.inverse_log_det_jacobian(y).numpy(),
        ref_np(ref.inverse_log_det_jacobian(paddle.to_tensor(y.numpy()))),
        **TOL)


def test_event_transforms_and_composites():
    x = _R.randn(2, 3).astype(np.float32)
    for name, args in (("SoftmaxTransform", ()),
                       ("StickBreakingTransform", ()),
                       ("ReshapeTransform", ((3,), (3, 1)))):
        port, ref = getattr(D, name)(*args), getattr(JD, name)(*args)
        y = port.forward(torch.tensor(x))
        np.testing.assert_allclose(y.numpy(), ref_np(ref.forward(
            paddle.to_tensor(x))), **TOL)
        assert port.forward_shape((2, 3)) == tuple(ref.forward_shape((2, 3)))
        if name != "SoftmaxTransform":
            np.testing.assert_allclose(port.inverse(y).numpy(), x, **TOL)
            np.testing.assert_allclose(
                port.forward_log_det_jacobian(torch.tensor(x)).numpy(),
                ref_np(ref.forward_log_det_jacobian(paddle.to_tensor(x))),
                **TOL)
    chain = D.ChainTransform([D.AffineTransform(1.0, 2.0),
                              D.ExpTransform()])
    rchain = JD.ChainTransform([JD.AffineTransform(1.0, 2.0),
                                JD.ExpTransform()])
    np.testing.assert_allclose(
        chain.forward_log_det_jacobian(torch.tensor(x)).numpy(),
        ref_np(rchain.forward_log_det_jacobian(paddle.to_tensor(x))), **TOL)
    stack = D.StackTransform([D.ExpTransform(), D.TanhTransform()], 1)
    rstack = JD.StackTransform([JD.ExpTransform(), JD.TanhTransform()], 1)
    x2 = x[:, :2].copy()
    np.testing.assert_allclose(stack.forward(torch.tensor(x2)).numpy(),
                               ref_np(rstack.forward(paddle.to_tensor(x2))),
                               **TOL)
    ind = D.IndependentTransform(D.ExpTransform(), 1)
    np.testing.assert_allclose(
        ind.forward_log_det_jacobian(torch.tensor(x)).numpy(),
        ref_np(JD.IndependentTransform(JD.ExpTransform(), 1)
               .forward_log_det_jacobian(paddle.to_tensor(x))), **TOL)


def test_transformed_and_independent():
    loc, scale = _R.randn(2, 3).astype(np.float32), _pos(2, 3)
    base, rbase = _pair("Normal", (loc, scale))
    td = D.TransformedDistribution(base, [D.AffineTransform(0.5, 2.0),
                                          D.ExpTransform()])
    rtd = JD.TransformedDistribution(rbase, [JD.AffineTransform(0.5, 2.0),
                                             JD.ExpTransform()])
    v = _pos(2, 3)
    np.testing.assert_allclose(td.log_prob(torch.tensor(v)).numpy(),
                               ref_np(rtd.log_prob(paddle.to_tensor(v))),
                               **TOL)
    assert D.ExpTransform()(base).batch_shape == (2, 3)
    pt.seed(0)
    assert (td.sample([5]) > 0).all()
    ind, rind = D.Independent(base, 1), JD.Independent(rbase, 1)
    assert ind.event_shape == (3,) and ind.batch_shape == (2,)
    v = _R.randn(2, 3).astype(np.float32)
    for got, want in ((ind.log_prob(torch.tensor(v)),
                       rind.log_prob(paddle.to_tensor(v))),
                      (ind.entropy(), rind.entropy())):
        np.testing.assert_allclose(got.numpy(), ref_np(want), **TOL)
    with pytest.raises(ValueError):
        D.Independent(base, 3)


def test_default_device():
    """Parameters given as tensors keep their device; scalars go to the
    default device, which without a GPU raises unless the CPU is asked
    for."""
    assert D.Normal(torch.tensor(0.0), 1.0).loc.device.type == "cpu"
    assert D.Normal(0.0, 1.0, device="cpu").scale.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.Normal(0.0, 1.0)

"""KL divergence. reference: paddle_tpu/distribution/kl.py
(`register_kl`, the most-derived dispatch, `_kl_expfamily_expfamily`, the
default pairwise rules).

`kl_divergence(p, q)` takes the registered rule of the most derived
(type(p), type(q)) pair, else p's own method when both are of one type,
else the Bregman divergence of the log-normalizer for two members of one
exponential family.
"""

from __future__ import annotations

import math

import torch

from .distribution import ExponentialFamily, Distribution, \
    _normalizer_and_grads

__all__ = ["kl_divergence", "register_kl"]

_REGISTRY = {}


def register_kl(cls_p, cls_q):
    """A decorator registering a pairwise KL rule."""
    def decorator(f):
        _REGISTRY[(cls_p, cls_q)] = f
        return f
    return decorator


def _dispatch(type_p, type_q):
    matches = [(p, q) for (p, q) in _REGISTRY
               if issubclass(type_p, p) and issubclass(type_q, q)]
    if not matches:
        return None
    # the most derived match wins (MRO distance, p first)
    return _REGISTRY[min(matches, key=lambda pq: (
        type_p.__mro__.index(pq[0]), type_q.__mro__.index(pq[1])))]


def kl_divergence(p, q):
    """KL(p || q)."""
    fn = _dispatch(type(p), type(q))
    if fn is not None:
        return fn(p, q)
    if type(p) is type(q):
        own = type(p).kl_divergence
        if own is not Distribution.kl_divergence:
            return own(p, q)
    if isinstance(p, ExponentialFamily) and type(p) is type(q):
        return _kl_expfamily_expfamily(p, q)
    raise NotImplementedError(
        f"KL divergence between {type(p).__name__} and {type(q).__name__} "
        "is not implemented; use register_kl to add it.")


def _kl_expfamily_expfamily(p, q):
    """The Bregman divergence of the log-normalizer, for two members of one
    exponential family: A(q) - A(p) - <theta_q - theta_p, grad A(p)>."""
    p_nat = [x.detach() for x in p._natural_parameters]
    q_nat = [x.detach() for x in q._natural_parameters]
    lg_p, grads = _normalizer_and_grads(p, p_nat)
    kl = q._log_normalizer(*q_nat) - lg_p
    for pn, qn, g in zip(p_nat, q_nat, grads):
        kl = kl - (qn - pn) * g
    return kl


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _register_defaults():
    from .continuous import (Beta, Cauchy, ContinuousBernoulli, Exponential,
                             Gamma, Laplace, LogNormal, Normal, Uniform)
    from .discrete import Bernoulli, Binomial, Categorical, Geometric, \
        Poisson
    from .multivariate import Dirichlet, MultivariateNormal

    for cls in (Normal, Cauchy, Laplace, Bernoulli, Categorical, Geometric,
                Poisson, Binomial, Dirichlet, MultivariateNormal):
        def make(c):
            def f(p, q):
                return c.kl_divergence(p, q)
            return f
        register_kl(cls, cls)(make(cls))

    @register_kl(LogNormal, LogNormal)
    def _kl_lognormal(p, q):
        return p._base.kl_divergence(q._base)

    @register_kl(Uniform, Uniform)
    def _kl_uniform(p, q):
        r = (q.high - q.low) / (p.high - p.low)
        inside = (q.low <= p.low) & (p.high <= q.high)
        return torch.where(inside, torch.log(r), torch.full_like(r, math.inf))

    @register_kl(Exponential, Exponential)
    def _kl_exponential(p, q):
        ratio = q.rate / p.rate
        return torch.log(1 / ratio) + ratio - 1

    @register_kl(Gamma, Gamma)
    def _kl_gamma(p, q):
        a1, b1, a2, b2 = p.concentration, p.rate, q.concentration, q.rate
        return ((a1 - a2) * torch.digamma(a1) - torch.lgamma(a1)
                + torch.lgamma(a2) + a2 * (torch.log(b1) - torch.log(b2))
                + a1 * (b2 - b1) / b1)

    @register_kl(ContinuousBernoulli, ContinuousBernoulli)
    def _kl_cb(p, q):
        # the log-density is linear in x: E_p[log p - log q] needs p's mean
        pp = torch.clamp(p.probs, 1e-7, 1 - 1e-7)
        qq = torch.clamp(q.probs, 1e-7, 1 - 1e-7)
        m = p.mean
        return (m * (torch.log(pp) - torch.log(qq))
                + (1 - m) * (torch.log1p(-pp) - torch.log1p(-qq))
                + p._log_norm() - q._log_norm())

    @register_kl(Beta, Beta)
    def _kl_beta(p, q):
        a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta
        s1 = a1 + b1
        return (_betaln(a2, b2) - _betaln(a1, b1)
                + (a1 - a2) * torch.digamma(a1)
                + (b1 - b2) * torch.digamma(b1)
                + (a2 - a1 + b2 - b1) * torch.digamma(s1))


_register_defaults()

"""Continuous univariate distributions. reference:
paddle_tpu/distribution/continuous.py (Normal, LogNormal, Uniform, Beta,
Gamma, Chi2, Exponential, Cauchy, Gumbel, Laplace, StudentT,
ContinuousBernoulli), with the reference's parametrisations and formulas
in torch and torch.special. Draws as jax.random makes them: Beta from two
Gammas, StudentT as a normal over the square root of a scaled Gamma,
Laplace as sign(u) log1p(-|u|), Gumbel as -log(-log(u)).
"""

from __future__ import annotations

import math

import torch

from .distribution import (Distribution, ExponentialFamily, _broadcast,
                           _params)

__all__ = [
    "Normal", "Uniform", "Beta", "Gamma", "Exponential", "Cauchy", "Chi2",
    "Gumbel", "Laplace", "LogNormal", "StudentT", "ContinuousBernoulli",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _tiny(dtype):
    return torch.finfo(dtype).tiny


class Normal(ExponentialFamily):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        self._device = self.loc.device
        super().__init__(_broadcast(self.loc.shape, self.scale.shape), ())

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return (self.scale ** 2).expand(self.batch_shape)

    @property
    def stddev(self):
        return self.scale.expand(self.batch_shape)

    def rsample(self, shape=()):
        eps = self._normal(self._extend_shape(shape), self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        v = self._value(value)
        var = self.scale ** 2
        return -((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale) \
            - _HALF_LOG_2PI

    def entropy(self):
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale.expand(
            self.batch_shape))

    def cdf(self, value):
        v = self._value(value)
        return 0.5 * (1 + torch.erf((v - self.loc) / (self.scale
                                                      * math.sqrt(2))))

    def icdf(self, value):
        v = self._value(value)
        return self.loc + self.scale * math.sqrt(2) * torch.erfinv(2 * v - 1)

    def kl_divergence(self, other):
        if isinstance(other, Normal):
            var_ratio = (self.scale / other.scale) ** 2
            t1 = ((self.loc - other.loc) / other.scale) ** 2
            return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
        return super().kl_divergence(other)

    @property
    def _natural_parameters(self):
        s2 = self.scale ** 2
        return (self.loc / s2, -0.5 / s2)

    def _log_normalizer(self, n1, n2):
        return -0.25 * n1 ** 2 / n2 + 0.5 * torch.log(-math.pi / n2)


class LogNormal(Distribution):
    """exp(Normal(loc, scale))."""

    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        self._device = self.loc.device
        self._base = Normal(self.loc, self.scale)
        super().__init__(self._base.batch_shape, ())

    @property
    def mean(self):
        return torch.exp(self.loc + self.scale ** 2 / 2)

    @property
    def variance(self):
        s2 = self.scale ** 2
        return (torch.exp(s2) - 1) * torch.exp(2 * self.loc + s2)

    def rsample(self, shape=()):
        return torch.exp(self._base.rsample(shape))

    def log_prob(self, value):
        v = self._value(value)
        return self._base.log_prob(torch.log(v)) - torch.log(v)

    def entropy(self):
        return self._base.entropy() + self.loc


class Uniform(Distribution):
    def __init__(self, low, high, name=None, *, device=None):
        self.low, self.high = _params(low, high, device=device)
        self._device = self.low.device
        super().__init__(_broadcast(self.low.shape, self.high.shape), ())

    @property
    def mean(self):
        return ((self.low + self.high) / 2).expand(self.batch_shape)

    @property
    def variance(self):
        return ((self.high - self.low) ** 2 / 12).expand(self.batch_shape)

    def rsample(self, shape=()):
        u = self._uniform(self._extend_shape(shape), self.low.dtype)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        v = self._value(value)
        inside = (v >= self.low) & (v < self.high)
        return torch.where(inside, -torch.log(self.high - self.low),
                           torch.full_like(v, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low).expand(self.batch_shape)

    def cdf(self, value):
        v = self._value(value)
        return torch.clamp((v - self.low) / (self.high - self.low), 0.0, 1.0)


class Beta(ExponentialFamily):
    def __init__(self, alpha, beta, name=None, *, device=None):
        self.alpha, self.beta = _params(alpha, beta, device=device)
        self._device = self.alpha.device
        super().__init__(_broadcast(self.alpha.shape, self.beta.shape), ())

    @property
    def mean(self):
        return (self.alpha / (self.alpha + self.beta)).expand(
            self.batch_shape)

    @property
    def variance(self):
        s = self.alpha + self.beta
        return (self.alpha * self.beta / (s ** 2 * (s + 1))).expand(
            self.batch_shape)

    def rsample(self, shape=()):
        full = self._extend_shape(shape)
        x = self._gamma(self.alpha, full)
        y = self._gamma(self.beta, full)
        return x / (x + y)

    def log_prob(self, value):
        v = self._value(value)
        a, b = self.alpha, self.beta
        lp = torch.special.xlogy(a - 1, v) + torch.special.xlog1py(
            b - 1, -v) - _betaln(a, b)
        return torch.where((v > 1) | (v < 0), torch.full_like(lp, -math.inf),
                           lp)

    def entropy(self):
        a, b = self.alpha, self.beta
        ent = (_betaln(a, b) - (a - 1) * torch.digamma(a)
               - (b - 1) * torch.digamma(b)
               + (a + b - 2) * torch.digamma(a + b))
        return ent.expand(self.batch_shape)

    @property
    def _natural_parameters(self):
        return (self.alpha - 1, self.beta - 1)

    def _log_normalizer(self, n1, n2):
        return _betaln(n1 + 1, n2 + 1)


class Gamma(ExponentialFamily):
    """Gamma(concentration, rate)."""

    def __init__(self, concentration, rate, name=None, *, device=None):
        self.concentration, self.rate = _params(concentration, rate,
                                                device=device)
        self._device = self.concentration.device
        super().__init__(_broadcast(self.concentration.shape,
                                    self.rate.shape), ())

    @property
    def mean(self):
        return (self.concentration / self.rate).expand(self.batch_shape)

    @property
    def variance(self):
        return (self.concentration / self.rate ** 2).expand(self.batch_shape)

    def rsample(self, shape=()):
        return self._gamma(self.concentration,
                           self._extend_shape(shape)) / self.rate

    def log_prob(self, value):
        v = self._value(value)
        a, r = self.concentration, self.rate
        return a * torch.log(r) + (a - 1) * torch.log(v) - r * v \
            - torch.lgamma(a)

    def entropy(self):
        a, r = self.concentration, self.rate
        ent = a - torch.log(r) + torch.lgamma(a) + (1 - a) * torch.digamma(a)
        return ent.expand(self.batch_shape)

    @property
    def _natural_parameters(self):
        return (self.concentration - 1, -self.rate)

    def _log_normalizer(self, n1, n2):
        return torch.lgamma(n1 + 1) - (n1 + 1) * torch.log(-n2)


class Chi2(Gamma):
    """Chi2(df) = Gamma(df / 2, 1 / 2)."""

    def __init__(self, df, name=None, *, device=None):
        (df,) = _params(df, device=device)
        self.df = df
        super().__init__(df / 2, torch.tensor(0.5, dtype=df.dtype,
                                              device=df.device))


class Exponential(ExponentialFamily):
    def __init__(self, rate, name=None, *, device=None):
        (self.rate,) = _params(rate, device=device)
        self._device = self.rate.device
        super().__init__(self.rate.shape, ())

    @property
    def mean(self):
        return 1.0 / self.rate

    @property
    def variance(self):
        return 1.0 / self.rate ** 2

    def rsample(self, shape=()):
        e = torch.empty(self._extend_shape(shape), dtype=self.rate.dtype,
                        device=self._device).exponential_(
                            generator=self._generator())
        return e / self.rate

    def log_prob(self, value):
        v = self._value(value)
        return torch.log(self.rate) - self.rate * v

    def entropy(self):
        return 1.0 - torch.log(self.rate)

    def cdf(self, value):
        v = self._value(value)
        return 1 - torch.exp(-self.rate * v)

    @property
    def _natural_parameters(self):
        return (-self.rate,)

    def _log_normalizer(self, n1):
        return -torch.log(-n1)


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        self._device = self.loc.device
        super().__init__(_broadcast(self.loc.shape, self.scale.shape), ())

    @property
    def mean(self):
        raise ValueError("Cauchy distribution has no mean.")

    @property
    def variance(self):
        raise ValueError("Cauchy distribution has no variance.")

    def rsample(self, shape=()):
        u = self._uniform(self._extend_shape(shape), self.loc.dtype)
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, value):
        v = self._value(value)
        z = (v - self.loc) / self.scale
        return -math.log(math.pi) - torch.log(self.scale) - torch.log1p(z * z)

    def entropy(self):
        return torch.log(4 * math.pi * self.scale.expand(self.batch_shape))

    def cdf(self, value):
        v = self._value(value)
        return torch.atan((v - self.loc) / self.scale) / math.pi + 0.5

    def kl_divergence(self, other):
        if isinstance(other, Cauchy):
            a = (self.scale + other.scale) ** 2 + (self.loc - other.loc) ** 2
            return torch.log(a / (4 * self.scale * other.scale))
        return super().kl_divergence(other)


class Gumbel(Distribution):
    _EULER = 0.57721566490153286060

    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        self._device = self.loc.device
        super().__init__(_broadcast(self.loc.shape, self.scale.shape), ())

    @property
    def mean(self):
        return (self.loc + self.scale * self._EULER).expand(self.batch_shape)

    @property
    def variance(self):
        return (math.pi ** 2 / 6 * self.scale ** 2).expand(self.batch_shape)

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    def rsample(self, shape=()):
        dt = self.loc.dtype
        u = self._uniform(self._extend_shape(shape), dt, _tiny(dt), 1.0)
        return self.loc + self.scale * -torch.log(-torch.log(u))

    def log_prob(self, value):
        v = self._value(value)
        z = (v - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    def entropy(self):
        return torch.log(self.scale.expand(self.batch_shape)) + 1 \
            + self._EULER

    def cdf(self, value):
        v = self._value(value)
        return torch.exp(-torch.exp(-(v - self.loc) / self.scale))


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        self._device = self.loc.device
        super().__init__(_broadcast(self.loc.shape, self.scale.shape), ())

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return (2 * self.scale ** 2).expand(self.batch_shape)

    @property
    def stddev(self):
        return (math.sqrt(2.0) * self.scale).expand(self.batch_shape)

    def rsample(self, shape=()):
        dt = self.loc.dtype
        u = self._uniform(self._extend_shape(shape), dt,
                          -1 + torch.finfo(dt).eps / 2, 1.0)
        return self.loc + self.scale * torch.sign(u) * torch.log1p(-u.abs())

    def log_prob(self, value):
        v = self._value(value)
        return -torch.abs(v - self.loc) / self.scale - torch.log(
            2 * self.scale)

    def entropy(self):
        return 1 + torch.log(2 * self.scale.expand(self.batch_shape))

    def cdf(self, value):
        v = self._value(value)
        z = (v - self.loc) / self.scale
        return 0.5 - 0.5 * torch.sign(z) * torch.expm1(-torch.abs(z))

    def icdf(self, value):
        v = self._value(value)
        term = v - 0.5
        return self.loc - self.scale * torch.sign(term) * torch.log1p(
            -2 * torch.abs(term))

    def kl_divergence(self, other):
        if isinstance(other, Laplace):
            d = torch.abs(self.loc - other.loc)
            return (torch.log(other.scale / self.scale) + d / other.scale
                    + self.scale / other.scale * torch.exp(-d / self.scale)
                    - 1)
        return super().kl_divergence(other)


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0, name=None, *, device=None):
        self.df, self.loc, self.scale = _params(df, loc, scale,
                                                device=device)
        self._device = self.df.device
        super().__init__(_broadcast(self.df.shape, self.loc.shape,
                                    self.scale.shape), ())

    @property
    def mean(self):
        m = torch.where(self.df > 1, self.loc,
                        torch.full_like(self.loc, math.nan))
        return m.expand(self.batch_shape)

    @property
    def variance(self):
        df = self.df
        v = torch.where(df > 2, self.scale ** 2 * df / (df - 2),
                        torch.where(df > 1, torch.full_like(df, math.inf),
                                    torch.full_like(df, math.nan)))
        return v.expand(self.batch_shape)

    def rsample(self, shape=()):
        full = self._extend_shape(shape)
        n = self._normal(full, self.loc.dtype)
        half = self.df / 2
        g = self._gamma(half, full)
        return self.loc + self.scale * n * torch.sqrt(half / g)

    def log_prob(self, value):
        v = self._value(value)
        z = (v - self.loc) / self.scale
        d = self.df
        t = (torch.lgamma((d + 1) / 2) - torch.lgamma(d / 2)
             - 0.5 * torch.log(d * math.pi)
             - (d + 1) / 2 * torch.log1p(z * z / d))
        return t - torch.log(self.scale)

    def entropy(self):
        d = self.df
        ent = ((d + 1) / 2 * (torch.digamma((d + 1) / 2)
                              - torch.digamma(d / 2))
               + torch.log(torch.sqrt(d))
               + _betaln(d / 2, torch.full_like(d, 0.5))
               + torch.log(self.scale))
        return ent.expand(self.batch_shape)


class ContinuousBernoulli(Distribution):
    def __init__(self, probs, lims=(0.499, 0.501), name=None, *,
                 device=None):
        (self.probs,) = _params(probs, device=device)
        self._device = self.probs.device
        self._lims = lims
        super().__init__(self.probs.shape, ())

    def _outside_unstable(self):
        return (self.probs < self._lims[0]) | (self.probs > self._lims[1])

    def _stable_probs(self):
        return torch.where(self._outside_unstable(), self.probs,
                           torch.full_like(self.probs, self._lims[0]))

    def _log_norm(self):
        """log C(p): C = 2 atanh(1 - 2p) / (1 - 2p), 2 at p = 0.5 (a
        Taylor expansion near it)."""
        p = self._stable_probs()
        out = torch.log(torch.abs(2 * torch.atanh(1 - 2 * p))) - torch.log(
            torch.abs(1 - 2 * p))
        taylor = math.log(2.0) + 4 / 3 * (self.probs - 0.5) ** 2
        return torch.where(self._outside_unstable(), out, taylor)

    @property
    def mean(self):
        p = self._stable_probs()
        m = p / (2 * p - 1) + 1 / (2 * torch.atanh(1 - 2 * p))
        taylor = 0.5 + (self.probs - 0.5) / 3
        return torch.where(self._outside_unstable(), m, taylor)

    @property
    def variance(self):
        p = self._stable_probs()
        v = p * (p - 1) / (1 - 2 * p) ** 2 + 1 / (2 * torch.atanh(
            1 - 2 * p)) ** 2
        taylor = 1 / 12 - (self.probs - 0.5) ** 2 / 15
        return torch.where(self._outside_unstable(), v, taylor)

    def rsample(self, shape=()):
        u = self._uniform(self._extend_shape(shape), self.probs.dtype)
        return self.icdf(u)

    def log_prob(self, value):
        v = self._value(value)
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return v * torch.log(p) + (1 - v) * torch.log1p(-p) + \
            self._log_norm()

    def cdf(self, value):
        v = self._value(value)
        p = self._stable_probs()
        c = (p ** v * (1 - p) ** (1 - v) + p - 1) / (2 * p - 1)
        out = torch.where(self._outside_unstable(), c, v)
        return torch.clamp(out, 0.0, 1.0)

    def icdf(self, value):
        v = self._value(value)
        p = self._stable_probs()
        x = torch.log1p(v * (2 * p - 1) / (1 - p)) / (
            torch.log(p) - torch.log1p(-p))
        return torch.where(self._outside_unstable(), x, v)

    def entropy(self):
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        m = self.mean
        return -(m * torch.log(p) + (1 - m) * torch.log1p(-p)
                 + self._log_norm())

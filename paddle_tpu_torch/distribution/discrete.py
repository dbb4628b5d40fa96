"""Discrete distributions. reference: paddle_tpu/distribution/discrete.py
(Bernoulli, Binomial, Categorical, Geometric, Multinomial, Poisson), the
reference's parametrisations and formulas in torch. Categorical takes
unnormalised log-probabilities (`logits`), as the reference's does;
Geometric counts the failures before the first success (support 0, 1,
...). Multinomial's entropy for more than one trial is the reference's
Monte-Carlo estimate over 512 draws.
"""

from __future__ import annotations

import math

import torch

from .distribution import (Distribution, ExponentialFamily, _broadcast,
                           _params, _shape)

__all__ = ["Bernoulli", "Binomial", "Categorical", "Geometric", "Multinomial",
           "Poisson"]


class Bernoulli(ExponentialFamily):
    def __init__(self, probs, name=None, *, device=None):
        (self.probs,) = _params(probs, device=device)
        self._device = self.probs.device
        self.logits = torch.log(self.probs) - torch.log1p(-self.probs)
        super().__init__(self.probs.shape, ())

    @property
    def mean(self):
        return self.probs

    @property
    def variance(self):
        return self.probs * (1 - self.probs)

    def sample(self, shape=()):
        with torch.no_grad():
            p = self.probs.expand(self._extend_shape(shape))
            return torch.bernoulli(p, generator=self._generator()).to(
                self.probs.dtype)

    def rsample(self, shape=(), temperature=1.0):
        """The relaxed draw: (logits + logistic noise) / temperature."""
        u = self._uniform(self._extend_shape(shape), self.probs.dtype,
                          1e-6, 1 - 1e-6)
        logistic = torch.log(u) - torch.log1p(-u)
        return (self.logits + logistic) / temperature

    def log_prob(self, value):
        v = self._value(value)
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return v * torch.log(p) + (1 - v) * torch.log1p(-p)

    def entropy(self):
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))

    def cdf(self, value):
        v = self._value(value)
        one = torch.ones_like(v)
        return torch.where(v < 0, torch.zeros_like(v),
                           torch.where(v < 1, 1 - self.probs, one))

    @property
    def _natural_parameters(self):
        return (self.logits,)

    def _log_normalizer(self, n1):
        return torch.logaddexp(torch.zeros_like(n1), n1)

    def kl_divergence(self, other):
        if isinstance(other, Bernoulli):
            p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
            q = torch.clamp(other.probs, 1e-7, 1 - 1e-7)
            return p * (torch.log(p) - torch.log(q)) + (1 - p) * (
                torch.log1p(-p) - torch.log1p(-q))
        return super().kl_divergence(other)


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None, *, device=None):
        dev = _params(probs, device=device)[0].device
        self.total_count = torch.as_tensor(total_count, device=dev)
        (self.probs,) = _params(probs, device=dev)
        self._device = dev
        super().__init__(_broadcast(self.total_count.shape,
                                    self.probs.shape), ())

    @property
    def mean(self):
        return (self.total_count * self.probs).expand(self.batch_shape)

    @property
    def variance(self):
        return (self.total_count * self.probs * (1 - self.probs)).expand(
            self.batch_shape)

    def sample(self, shape=()):
        """The sum of total_count Bernoulli draws (the reference's
        method: max(total_count) uniforms per draw)."""
        with torch.no_grad():
            n = int(self.total_count.max())
            full = self._extend_shape(shape)
            u = self._uniform((n,) + full, self.probs.dtype)
            idx = torch.arange(n, device=self._device).reshape(
                (n,) + (1,) * len(full))
            draws = (u < self.probs) & (idx < self.total_count)
            return draws.sum(0).to(self.probs.dtype)

    def log_prob(self, value):
        v = self._value(value)
        n = self.total_count
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        comb = torch.lgamma(n + 1.0) - torch.lgamma(v + 1) - torch.lgamma(
            n - v + 1)
        return comb + v * torch.log(p) + (n - v) * torch.log1p(-p)

    def entropy(self):
        n = int(self.total_count.max())
        ks = torch.arange(n + 1, dtype=self.probs.dtype, device=self._device)
        ks = ks.reshape((n + 1,) + (1,) * len(self.batch_shape))
        lp = self.log_prob(ks)
        valid = ks <= self.total_count
        return -torch.where(valid, torch.exp(lp) * lp,
                            torch.zeros_like(lp)).sum(0)

    def kl_divergence(self, other):
        if isinstance(other, Binomial):
            p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
            q = torch.clamp(other.probs, 1e-7, 1 - 1e-7)
            return self.total_count * (
                p * (torch.log(p) - torch.log(q))
                + (1 - p) * (torch.log1p(-p) - torch.log1p(-q)))
        return super().kl_divergence(other)


class Categorical(Distribution):
    """Categorical(logits), logits being unnormalised log-probabilities."""

    def __init__(self, logits, name=None, *, device=None):
        (self.logits,) = _params(logits, device=device)
        self._device = self.logits.device
        self._log_p = self.logits - torch.logsumexp(self.logits, -1,
                                                    keepdim=True)
        super().__init__(self.logits.shape[:-1], ())
        self._num_events = self.logits.shape[-1]

    @property
    def probs_param(self):
        return torch.exp(self._log_p)

    def sample(self, shape=()):
        with torch.no_grad():
            s = _shape(shape)
            n = math.prod(s) or 1
            flat = self.probs_param.reshape(-1, self._num_events)
            draws = torch.multinomial(flat, n, replacement=True,
                                      generator=self._generator())
            draws = draws.T.reshape(s + self.batch_shape)
            return draws

    def log_prob(self, value):
        v = self._value(value).long()
        lp = self._log_p.expand(tuple(v.shape) + (self._num_events,))
        return torch.gather(lp, -1, v[..., None])[..., 0]

    def probs(self, value):
        v = self._value(value).long()
        p = self.probs_param.expand(tuple(v.shape) + (self._num_events,))
        return torch.gather(p, -1, v[..., None])[..., 0]

    def entropy(self):
        return -(self.probs_param * self._log_p).sum(-1)

    def kl_divergence(self, other):
        if isinstance(other, Categorical):
            return (self.probs_param * (self._log_p - other._log_p)).sum(-1)
        from .kl import kl_divergence
        return kl_divergence(self, other)


class Geometric(Distribution):
    """The failures before the first success, support 0, 1, ..."""

    def __init__(self, probs, name=None, *, device=None):
        (self.probs,) = _params(probs, device=device)
        self._device = self.probs.device
        super().__init__(self.probs.shape, ())

    @property
    def mean(self):
        return 1.0 / self.probs - 1.0

    @property
    def variance(self):
        return (1 - self.probs) / self.probs ** 2

    @property
    def stddev(self):
        return torch.sqrt((1 - self.probs) / self.probs ** 2)

    def sample(self, shape=()):
        with torch.no_grad():
            return self.rsample(shape)

    def rsample(self, shape=()):
        u = self._uniform(self._extend_shape(shape), self.probs.dtype,
                          1e-7, 1.0)
        return torch.floor(torch.log(u) / torch.log1p(-self.probs))

    def log_prob(self, value):
        v = self._value(value)
        return v * torch.log1p(-self.probs) + torch.log(self.probs)

    def entropy(self):
        p = self.probs
        return -((1 - p) * torch.log1p(-p) + p * torch.log(p)) / p

    def cdf(self, value):
        v = self._value(value)
        return 1 - torch.pow(1 - self.probs, torch.floor(v) + 1)

    def kl_divergence(self, other):
        if isinstance(other, Geometric):
            p, q = self.probs, other.probs
            return torch.log(p / q) + (1 - p) / p * torch.log(
                (1 - p) / (1 - q))
        return super().kl_divergence(other)


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None, *, device=None):
        self.total_count = int(total_count)
        (probs,) = _params(probs, device=device)
        self._device = probs.device
        self.probs = probs / probs.sum(-1, keepdim=True)
        super().__init__(self.probs.shape[:-1], self.probs.shape[-1:])

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)

    def sample(self, shape=()):
        with torch.no_grad():
            k = self.probs.shape[-1]
            full = _shape(shape) + self.batch_shape
            m = math.prod(full) or 1
            flat = self.probs.expand(full + (k,)).reshape(m, k)
            draws = torch.multinomial(flat, self.total_count,
                                      replacement=True,
                                      generator=self._generator())
            counts = torch.zeros(m, k, dtype=self.probs.dtype,
                                 device=self._device)
            counts.scatter_add_(1, draws, torch.ones_like(
                draws, dtype=self.probs.dtype))
            return counts.reshape(full + (k,))

    def log_prob(self, value):
        v = self._value(value)
        logits = torch.log(torch.clamp(self.probs, min=1e-12))
        return (torch.lgamma(v.sum(-1) + 1) - torch.lgamma(v + 1).sum(-1)
                + (v * logits).sum(-1))

    def entropy(self):
        p = torch.clamp(self.probs, min=1e-12)
        if self.total_count == 1:
            return -(p * torch.log(p)).sum(-1)
        samples = self.sample((512,))
        return -self.log_prob(samples).mean(0)


class Poisson(ExponentialFamily):
    def __init__(self, rate, name=None, *, device=None):
        (self.rate,) = _params(rate, device=device)
        self._device = self.rate.device
        super().__init__(self.rate.shape, ())

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate

    def sample(self, shape=()):
        with torch.no_grad():
            r = self.rate.expand(self._extend_shape(shape)).contiguous()
            return torch.poisson(r, generator=self._generator()).to(
                self.rate.dtype)

    def log_prob(self, value):
        v = self._value(value)
        return v * torch.log(self.rate) - self.rate - torch.lgamma(v + 1)

    def entropy(self):
        """The series over 0 .. rate + 30 sqrt(max(rate, 1))."""
        r = float(self.rate.max())
        n = int(r + 30 * math.sqrt(max(r, 1.0)))
        ks = torch.arange(n + 1, dtype=self.rate.dtype, device=self._device)
        ks = ks.reshape((n + 1,) + (1,) * len(self.batch_shape))
        lp = ks * torch.log(self.rate) - self.rate - torch.lgamma(ks + 1)
        return -(torch.exp(lp) * lp).sum(0)

    def kl_divergence(self, other):
        if isinstance(other, Poisson):
            r, s = self.rate, other.rate
            return r * torch.log(r / s) - r + s
        return super().kl_divergence(other)

    @property
    def _natural_parameters(self):
        return (torch.log(self.rate),)

    def _log_normalizer(self, n1):
        return torch.exp(n1)

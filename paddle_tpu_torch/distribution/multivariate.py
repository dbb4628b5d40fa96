"""Multivariate distributions. reference:
paddle_tpu/distribution/multivariate.py (Dirichlet, MultivariateNormal,
LKJCholesky), the reference's formulas in torch: Dirichlet draws as
normalised Gammas, MultivariateNormal through its Cholesky factor,
LKJCholesky's draws by the onion method.
"""

from __future__ import annotations

import math

import torch

from .distribution import (Distribution, ExponentialFamily, _broadcast,
                           _params, _shape)

__all__ = ["Dirichlet", "MultivariateNormal", "LKJCholesky"]


def _diag(L):
    return torch.diagonal(L, dim1=-2, dim2=-1)


def _solve_lower(L, b):
    """L^-1 b for lower-triangular L (..., d, d) and b (..., d)."""
    L = L.expand(tuple(b.shape[:-1]) + tuple(L.shape[-2:]))
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


class Dirichlet(ExponentialFamily):
    def __init__(self, concentration, name=None, *, device=None):
        (self.concentration,) = _params(concentration, device=device)
        self._device = self.concentration.device
        if self.concentration.dim() < 1:
            raise ValueError("concentration must be at least 1-dimensional")
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    @property
    def mean(self):
        return self.concentration / self.concentration.sum(-1, keepdim=True)

    @property
    def variance(self):
        a0 = self.concentration.sum(-1, keepdim=True)
        m = self.concentration / a0
        return m * (1 - m) / (a0 + 1)

    def rsample(self, shape=()):
        g = self._gamma(self.concentration, self._extend_shape(shape))
        return g / g.sum(-1, keepdim=True)

    def log_prob(self, value):
        v = self._value(value)
        a = self.concentration
        return ((a - 1) * torch.log(v)).sum(-1) + torch.lgamma(a.sum(-1)) \
            - torch.lgamma(a).sum(-1)

    def entropy(self):
        a = self.concentration
        a0 = a.sum(-1)
        k = a.shape[-1]
        lnB = torch.lgamma(a).sum(-1) - torch.lgamma(a0)
        return lnB + (a0 - k) * torch.digamma(a0) - (
            (a - 1) * torch.digamma(a)).sum(-1)

    def kl_divergence(self, other):
        if isinstance(other, Dirichlet):
            a, b = self.concentration, other.concentration
            a0 = a.sum(-1)
            return (torch.lgamma(a0) - torch.lgamma(a).sum(-1)
                    - torch.lgamma(b.sum(-1)) + torch.lgamma(b).sum(-1)
                    + ((a - b) * (torch.digamma(a)
                                  - torch.digamma(a0)[..., None])).sum(-1))
        return super().kl_divergence(other)


class MultivariateNormal(Distribution):
    """MultivariateNormal(loc, one of covariance_matrix, precision_matrix,
    scale_tril)."""

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, name=None, *, device=None):
        given = [x for x in (covariance_matrix, precision_matrix,
                             scale_tril) if x is not None]
        if len(given) != 1:
            raise ValueError("Exactly one of covariance_matrix, "
                             "precision_matrix, scale_tril must be given")
        self.loc, m = _params(loc, given[0], device=device)
        self._device = self.loc.device
        if scale_tril is not None:
            self._scale_tril = m
        elif covariance_matrix is not None:
            self._scale_tril = torch.linalg.cholesky(m)
        else:
            self._scale_tril = torch.linalg.cholesky(torch.linalg.inv(m))
        d = self.loc.shape[-1]
        super().__init__(_broadcast(self.loc.shape[:-1],
                                    self._scale_tril.shape[:-2]), (d,))

    @property
    def scale_tril(self):
        return self._scale_tril

    @property
    def covariance_matrix(self):
        L = self._scale_tril
        return L @ L.transpose(-1, -2)

    @property
    def precision_matrix(self):
        return torch.linalg.inv(self.covariance_matrix)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        return (self._scale_tril ** 2).sum(-1).expand(
            self.batch_shape + self.event_shape)

    def rsample(self, shape=()):
        eps = self._normal(self._extend_shape(shape), self.loc.dtype)
        return self.loc + torch.einsum("...ij,...j->...i", self._scale_tril,
                                       eps)

    def log_prob(self, value):
        v = self._value(value)
        d = self.event_shape[0]
        y = _solve_lower(self._scale_tril, v - self.loc)
        M = (y ** 2).sum(-1)
        half_logdet = torch.log(_diag(self._scale_tril)).sum(-1)
        return -0.5 * (d * math.log(2 * math.pi) + M) - half_logdet

    def entropy(self):
        d = self.event_shape[0]
        half_logdet = torch.log(_diag(self._scale_tril)).sum(-1)
        out = 0.5 * d * (1 + math.log(2 * math.pi)) + half_logdet
        return out.expand(self.batch_shape)

    def kl_divergence(self, other):
        if isinstance(other, MultivariateNormal):
            d = self.event_shape[0]
            L1, L2 = self._scale_tril, other._scale_tril
            logdet = torch.log(_diag(L2)).sum(-1) - torch.log(
                _diag(L1)).sum(-1)
            # tr(S2^-1 S1) = |L2^-1 L1|_F^2
            A = torch.linalg.solve(L2, L1)
            tr = (A ** 2).sum((-2, -1))
            y = _solve_lower(L2, other.loc - self.loc)
            M = (y ** 2).sum(-1)
            return logdet + 0.5 * (tr + M - d)
        return super().kl_divergence(other)


class LKJCholesky(Distribution):
    """The LKJ prior over Cholesky factors of correlation matrices; draws
    by the onion method ("cvine" is accepted and draws the same way)."""

    def __init__(self, dim, concentration=1.0, sample_method="onion",
                 name=None, *, device=None):
        self.dim = int(dim)
        (self.concentration,) = _params(concentration, device=device)
        self._device = self.concentration.device
        self.sample_method = sample_method
        if sample_method not in ("onion", "cvine"):
            raise ValueError("sample_method must be 'onion' or 'cvine'")
        super().__init__(self.concentration.shape, (self.dim, self.dim))

    def sample(self, shape=()):
        """Row i: a direction uniform on the sphere with squared radius
        from Beta(i / 2, eta + (d - i - 1) / 2)."""
        with torch.no_grad():
            d = self.dim
            batch = _shape(shape) + self.batch_shape
            eta = self.concentration.expand(self.batch_shape)
            L = torch.zeros(batch + (d, d), dtype=torch.float32,
                            device=self._device)
            L[..., 0, 0] = 1.0
            for i in range(1, d):
                b = eta + (d - i - 1) / 2.0
                ga = self._gamma(torch.tensor(i / 2.0, device=self._device),
                                 batch)
                gb = self._gamma(b.to(torch.float32), batch)
                y = ga / (ga + gb)                       # squared radius
                u = self._normal(batch + (i,), torch.float32)
                u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
                L[..., i, :i] = torch.sqrt(y)[..., None] * u
                L[..., i, i] = torch.sqrt(torch.clamp(1.0 - y, min=1e-12))
            return L

    def log_prob(self, value):
        L = self._value(value)
        d = self.dim
        eta = self.concentration
        diag = _diag(L)[..., 1:]
        orders = torch.arange(2, d + 1, dtype=L.dtype, device=L.device)
        unnorm = ((d - orders + 2 * eta[..., None] - 2) * torch.log(
            diag)).sum(-1)
        return unnorm - self._log_normalizer()

    def _log_normalizer(self):
        d = self.dim
        eta = self.concentration
        i = torch.arange(1, d, dtype=torch.float32, device=self._device)
        return ((i / 2.0) * math.log(math.pi)
                + torch.lgamma(eta[..., None] + (d - 1 - i) / 2.0)
                - torch.lgamma(eta[..., None] + (d - 1) / 2.0)).sum(-1)

"""Bijective transforms, TransformedDistribution and Independent.
reference: paddle_tpu/distribution/transform.py, the same taxonomy
(`Type.BIJECTION`, ...) and formulas in torch. A transform's parameters
(loc, scale, power) meet each input on its device and in its dtype.
"""

from __future__ import annotations

import enum
import math

import torch

from ..framework.device import resolve_device
from .distribution import Distribution, _arr

__all__ = [
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform",
    "TransformedDistribution", "Independent",
]


class Type(enum.Enum):
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"


def _like(p, x):
    """Parameter `p` as a tensor on `x`'s device (in its dtype unless `p`
    is a tensor)."""
    if isinstance(p, torch.Tensor):
        return p.to(x.device)
    return torch.as_tensor(p, dtype=x.dtype, device=x.device)


def _in(x):
    """An input as a tensor: a tensor as it is, anything else on the
    default device."""
    return x if isinstance(x, torch.Tensor) else _arr(
        x, device=resolve_device())


def _softplus0(x):
    """log(1 + exp(x)) = logaddexp(0, x)."""
    return torch.logaddexp(torch.zeros_like(x), x)


class Transform:
    _type = Type.INJECTION
    # event dims the transform consumes and produces
    _domain_event_rank = 0
    _codomain_event_rank = 0

    @classmethod
    def _is_injective(cls):
        return cls._type in (Type.BIJECTION, Type.INJECTION)

    def __call__(self, x):
        if isinstance(x, Distribution):
            return TransformedDistribution(x, [self])
        return self.forward(x)

    def forward(self, x):
        return self._forward(_in(x))

    def inverse(self, y):
        return self._inverse(_in(y))

    def forward_log_det_jacobian(self, x):
        return self._forward_log_det_jacobian(_in(x))

    def inverse_log_det_jacobian(self, y):
        return -self._forward_log_det_jacobian(self._inverse(_in(y)))

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)


class AbsTransform(Transform):
    _type = Type.SURJECTION

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y                     # the principal branch

    def _forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


class AffineTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def _forward(self, x):
        return _like(self.loc, x) + _like(self.scale, x) * x

    def _inverse(self, y):
        return (y - _like(self.loc, y)) / _like(self.scale, y)

    def _forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(_like(self.scale, x))).expand(x.shape)


class ExpTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, power):
        self.power = power

    def _forward(self, x):
        return torch.pow(x, _like(self.power, x))

    def _inverse(self, y):
        return torch.pow(y, 1.0 / _like(self.power, y))

    def _forward_log_det_jacobian(self, x):
        p = _like(self.power, x)
        return torch.log(torch.abs(p * torch.pow(x, p - 1)))


class SigmoidTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return 1 / (1 + torch.exp(-x))

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        return -_softplus0(-x) - _softplus0(x)


class TanhTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        return 2.0 * (math.log(2.0) - x - _softplus0(-2.0 * x))


class SoftmaxTransform(Transform):
    _type = Type.OTHER
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        raise NotImplementedError("SoftmaxTransform is not injective")


class StickBreakingTransform(Transform):
    _type = Type.BIJECTION
    _domain_event_rank = 1
    _codomain_event_rank = 1

    @staticmethod
    def _offset(x):
        return x.shape[-1] - torch.cumsum(torch.ones_like(x), -1) + 1

    def _forward(self, x):
        z = 1 / (1 + torch.exp(-(x - torch.log(self._offset(x)))))
        zc = torch.cumprod(1 - z, -1)
        pad = torch.ones(tuple(x.shape[:-1]) + (1,), dtype=x.dtype,
                         device=x.device)
        return torch.cat([z, pad], -1) * torch.cat([pad, zc], -1)

    def _inverse(self, y):
        y_crop = y[..., :-1]
        sf = 1 - torch.cumsum(y_crop, -1)
        return torch.log(y_crop / torch.clamp(sf, min=1e-12)) + torch.log(
            self._offset(y_crop))

    def _forward_log_det_jacobian(self, x):
        # log|det J| = sum_i (-x'_i + logsigmoid(x'_i) + log y_i), with
        # x' = x - log(offset)
        y = self._forward(x)
        xs = x - torch.log(self._offset(x))
        return (-xs - _softplus0(-xs) + torch.log(torch.clamp(
            y[..., :-1], min=1e-38))).sum(-1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class ReshapeTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)
        if math.prod(self.in_event_shape) != math.prod(self.out_event_shape):
            raise ValueError("in/out event sizes must match")
        self._domain_event_rank = len(self.in_event_shape)
        self._codomain_event_rank = len(self.out_event_shape)

    @staticmethod
    def _batch(shape, n):
        return tuple(shape[:len(shape) - n]) if n else tuple(shape)

    def _forward(self, x):
        return x.reshape(self._batch(x.shape, len(self.in_event_shape))
                         + self.out_event_shape)

    def _inverse(self, y):
        return y.reshape(self._batch(y.shape, len(self.out_event_shape))
                         + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        return torch.zeros(self._batch(x.shape, len(self.in_event_shape)),
                           dtype=x.dtype, device=x.device)

    def forward_shape(self, shape):
        return self._batch(shape, len(self.in_event_shape)) + \
            self.out_event_shape

    def inverse_shape(self, shape):
        return self._batch(shape, len(self.out_event_shape)) + \
            self.in_event_shape


class IndependentTransform(Transform):
    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        self._domain_event_rank = base._domain_event_rank + \
            self.reinterpreted_batch_rank
        self._codomain_event_rank = base._codomain_event_rank + \
            self.reinterpreted_batch_rank

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _forward_log_det_jacobian(self, x):
        ld = self.base._forward_log_det_jacobian(x)
        return ld.sum(tuple(range(-self.reinterpreted_batch_rank, 0)))


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)
        self._domain_event_rank = max(
            [t._domain_event_rank for t in self.transforms] or [0])
        self._codomain_event_rank = max(
            [t._codomain_event_rank for t in self.transforms] or [0])

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t._forward_log_det_jacobian(x)
            x = t._forward(x)
        return total

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return shape

    def inverse_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.inverse_shape(shape)
        return shape


class StackTransform(Transform):
    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = int(axis)

    def _unstack(self, x):
        return [s.squeeze(self.axis) for s in
                torch.tensor_split(x, len(self.transforms), self.axis)]

    def _map(self, fn, x):
        return torch.stack([fn(t, p) for t, p in zip(self.transforms,
                                                      self._unstack(x))],
                           self.axis)

    def _forward(self, x):
        return self._map(lambda t, p: t._forward(p), x)

    def _inverse(self, y):
        return self._map(lambda t, p: t._inverse(p), y)

    def _forward_log_det_jacobian(self, x):
        return self._map(lambda t, p: t._forward_log_det_jacobian(p), x)


class Independent(Distribution):
    """`base` with its trailing `reinterpreted_batch_rank` batch dims read
    as event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self._device = base._device
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        if self.reinterpreted_batch_rank > len(base.batch_shape):
            raise ValueError(
                "reinterpreted_batch_rank exceeds base batch rank")
        cut = len(base.batch_shape) - self.reinterpreted_batch_rank
        super().__init__(base.batch_shape[:cut],
                         base.batch_shape[cut:] + base.event_shape)

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return self.base.rsample(shape)

    def _reduce(self, t):
        axes = tuple(range(-self.reinterpreted_batch_rank, 0))
        return t.sum(axes) if axes else t

    def log_prob(self, value):
        return self._reduce(self.base.log_prob(value))

    def entropy(self):
        return self._reduce(self.base.entropy())


class TransformedDistribution(Distribution):
    """The distribution of T(X) for X ~ base and T the chain of
    `transforms`."""

    def __init__(self, base, transforms):
        self.base = base
        self._device = base._device
        self.transforms = list(transforms)
        chain = ChainTransform(self.transforms)
        shape = chain.forward_shape(base.batch_shape + base.event_shape)
        # the event rank grows to at least the chain's codomain event rank
        event_rank = max(len(base.event_shape), chain._codomain_event_rank)
        cut = len(shape) - event_rank
        super().__init__(shape[:cut], shape[cut:])
        self._chain = chain

    def sample(self, shape=()):
        return self._chain._forward(self.base.sample(shape))

    def rsample(self, shape=()):
        return self._chain._forward(self.base.rsample(shape))

    def log_prob(self, value):
        y = self._value(value)
        x = self._chain._inverse(y)
        ld = self._chain._forward_log_det_jacobian(x)
        base_lp = self.base.log_prob(x)
        # the base log-prob summed over the dims that became event dims
        extra = len(self.event_shape) - len(self.base.event_shape) - (
            self._chain._codomain_event_rank
            - self._chain._domain_event_rank)
        if extra > 0:
            base_lp = base_lp.sum(tuple(range(-extra, 0)))
        # the Jacobian summed over the event dims past its own rank
        jac_extra = len(self.event_shape) - self._chain._codomain_event_rank
        if jac_extra > 0 and torch.as_tensor(ld).dim() >= jac_extra:
            ld = ld.sum(tuple(range(-jac_extra, 0)))
        return base_lp - ld

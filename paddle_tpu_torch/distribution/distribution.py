"""Distribution base classes. reference:
paddle_tpu/distribution/distribution.py (`Distribution`,
`ExponentialFamily`).

Parameters become tensors on one device: that of the first tensor among
them, else the `device` keyword (the port's default device without it).
Draws come from the port's generator of that device (`paddle.seed`), so
they match the reference's in distribution, not in bits. `rsample` keeps
the draw differentiable in the parameters where the reference's math
allows it; `sample` returns it detached. Results are otherwise ordinary
tensors: gradients flow where torch can carry them.
"""

from __future__ import annotations

import torch

from ..framework.device import resolve_device
from ..framework.dtypes import default_float
from ..framework.random import get_generator

__all__ = ["Distribution", "ExponentialFamily"]


def _device_of(*xs, device=None):
    """The device of the first tensor among `xs`, else `device` (resolved:
    the port's default without it)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _arr(x, dtype=None, device=None):
    """A tensor of `x`: integers and bools as float32, Python and numpy
    floats in the default float dtype (the reference's arrays are float32
    without x64), on `device` unless `x` is a tensor already."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
    else:
        t = torch.as_tensor(x, device=device)
        if dtype is None and t.dtype == torch.float64:
            t = t.to(default_float())
    if dtype is not None:
        t = t.to(dtype)
    elif not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float32)
    return t


def _params(*xs, device=None):
    """The parameters `xs` as tensors on one device (`_device_of`'s rule)."""
    dev = _device_of(*xs, device=device)
    return [_arr(x, device=dev) for x in xs]


def _shape(s):
    if s is None:
        return ()
    if isinstance(s, int):
        return (s,)
    return tuple(int(d) for d in s)


def _broadcast(*shapes):
    return tuple(torch.broadcast_shapes(*[tuple(s) for s in shapes]))


class Distribution:
    """The base: `sample`/`rsample` prepend `shape` to batch_shape +
    event_shape, `prob` is exp(log_prob), and `kl_divergence` dispatches
    through distribution.kl's registry."""

    _device = torch.device("cpu")

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = _shape(batch_shape)
        self._event_shape = _shape(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def sample(self, shape=()):
        with torch.no_grad():
            return self.rsample(shape)

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def probs(self, value):
        return self.prob(value)

    def entropy(self):
        raise NotImplementedError

    def cdf(self, value):
        raise NotImplementedError

    def icdf(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        from .kl import kl_divergence
        return kl_divergence(self, other)

    # -- helpers of the subclasses -----------------------------------------
    def _extend_shape(self, sample_shape):
        return _shape(sample_shape) + self.batch_shape + self.event_shape

    def _generator(self):
        return get_generator(self._device)

    def _value(self, value):
        return _arr(value, device=self._device)

    def _uniform(self, shape, dtype, low=0.0, high=1.0):
        u = torch.rand(shape, dtype=dtype, device=self._device,
                       generator=self._generator())
        return low + (high - low) * u

    def _normal(self, shape, dtype):
        return torch.randn(shape, dtype=dtype, device=self._device,
                           generator=self._generator())

    def _gamma(self, alpha, shape):
        """Gamma(alpha, 1) draws of `shape` (alpha broadcast to it)."""
        return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                     generator=self._generator())

    def __repr__(self):
        return (f"{type(self).__name__}(batch_shape={self.batch_shape}, "
                f"event_shape={self.event_shape})")


class ExponentialFamily(Distribution):
    """Distributions of the natural exponential family: the entropy from
    the log-normalizer A and its gradient, H = A(theta) - <theta,
    grad A(theta)> - E[h(x)]."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        nparams = [p.detach() for p in self._natural_parameters]
        lg, grads = _normalizer_and_grads(self, nparams)
        ent = -self._mean_carrier_measure + lg
        for p, g in zip(nparams, grads):
            ent = ent - p * g
        return ent


def _normalizer_and_grads(dist, nparams):
    """(A(theta), grad A(theta)) of `dist`'s log-normalizer, detached."""
    with torch.enable_grad():
        ps = [p.detach().clone().requires_grad_(True) for p in nparams]
        lg = dist._log_normalizer(*ps)
        grads = torch.autograd.grad(lg.sum(), ps)
    return lg.detach(), [g.detach() for g in grads]

"""Random tensors. reference: paddle_tpu/tensor/random.py (all of it).

Draws come from the port's generator of the device they land on
(framework/random.py: `seed` restarts it), not from JAX keys, so they do
not reproduce the reference's bits; the tests hold them to its supports,
moments and shapes. Factories build on the default device (`set_device`)
unless `device=` names one; functions of a tensor draw on its device. The
in-place fillers (`normal_`, `uniform_`, ...) write under no_grad, as the
initializers do.
"""

from __future__ import annotations

import torch

from ..framework.device import resolve_device
from ..framework.dtypes import convert_dtype, default_float
from ..framework.random import get_generator

__all__ = [
    "rand", "randn", "standard_normal", "normal", "normal_", "uniform",
    "uniform_", "randint", "randint_like", "randperm", "bernoulli",
    "poisson", "multinomial", "standard_gamma", "binomial", "exponential_",
    "gumbel_softmax", "log_normal", "log_normal_", "bernoulli_",
    "cauchy_", "geometric_",
]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.reshape(-1).tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dtype(dtype):
    return default_float() if dtype is None else convert_dtype(dtype)


def _gen(device):
    return get_generator(device)


def rand(shape, dtype=None, name=None, *, device=None):
    """Uniform on [0, 1)."""
    dev = resolve_device(device)
    return torch.rand(_shape(shape), dtype=_dtype(dtype), device=dev,
                      generator=_gen(dev))


def randn(shape, dtype=None, name=None, *, device=None):
    dev = resolve_device(device)
    return torch.randn(_shape(shape), dtype=_dtype(dtype), device=dev,
                       generator=_gen(dev))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None, *, device=None):
    """mean + std * N(0, 1); tensor means and stds broadcast together and
    set the device."""
    tensors = [t for t in (mean, std) if isinstance(t, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        out_shape = torch.broadcast_shapes(
            *(t.shape for t in tensors))
    else:
        dev = resolve_device(device)
        out_shape = _shape(shape if shape is not None else [1])
    z = torch.randn(out_shape, dtype=torch.float32, device=dev,
                    generator=_gen(dev))
    return mean + std * z


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def _seeded(seed, device):
    """The port's generator of `device`, or a fresh one from `seed`."""
    if not seed:
        return _gen(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            device=None):
    dev = resolve_device(device)
    out = torch.empty(_shape(shape), dtype=_dtype(dtype), device=dev)
    return out.uniform_(min, max, generator=_seeded(seed, dev))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        return x.uniform_(min, max, generator=_seeded(seed, x.device))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            device=None):
    """Integers uniform on [low, high) ([0, low) without high)."""
    if high is None:
        low, high = 0, low
    dev = resolve_device(device)
    return torch.randint(low, high, _shape(shape), dtype=convert_dtype(dtype),
                         device=dev, generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    out = torch.randint(low, high, tuple(x.shape), device=x.device,
                        generator=_gen(x.device))
    return out.to(x.dtype if dtype is None else convert_dtype(dtype))


def randperm(n, dtype="int64", name=None, *, device=None):
    dev = resolve_device(device)
    return torch.randperm(n, device=dev, generator=_gen(dev)).to(
        convert_dtype(dtype))


def bernoulli(x, p=None, name=None):
    """1 with probability x (or p), else 0, in x's dtype."""
    prob = x if p is None else torch.full_like(x, p)
    return torch.bernoulli(prob.float(), generator=_gen(x.device)).to(
        x.dtype)


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        return x.bernoulli_(p, generator=_gen(x.device))


def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device)).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category indices (int64) drawn from each row's weights."""
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device))


def standard_gamma(x, name=None):
    """Gamma(x, 1) draws."""
    return torch._standard_gamma(x, generator=_gen(x.device))


def binomial(count, prob, name=None):
    """Binomial(count, prob) draws, int64."""
    count, prob = torch.broadcast_tensors(count.float(), prob.float())
    return torch.binomial(count, prob, generator=_gen(count.device)).to(
        torch.int64)


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))


def log_normal(mean=1.0, std=2.0, shape=None, name=None, *, device=None):
    return torch.exp(normal(mean, std, shape, device=device))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    with torch.no_grad():
        return x.log_normal_(mean, std, generator=_gen(x.device))


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        return x.cauchy_(loc, scale, generator=_gen(x.device))


def geometric_(x, probs=0.5, name=None):
    """Trials to the first success (1, 2, ...)."""
    with torch.no_grad():
        return x.geometric_(probs, generator=_gen(x.device))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g ~ Gumbel(0, 1); with `hard`,
    the one-hot of its argmax in the forward and the soft gradient (the
    straight-through estimator)."""
    e = torch.empty_like(x).exponential_(generator=_gen(x.device))
    y = torch.softmax((x - torch.log(e)) / temperature, dim=axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y

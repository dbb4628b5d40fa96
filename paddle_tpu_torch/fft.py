"""Discrete Fourier transforms over torch.fft. reference: paddle_tpu/fft.py.

Paddle's names and arguments (`axis`/`axes`, `s`, `norm` of "backward",
"ortho" or "forward") on torch.fft's transforms, which run cuFFT on the
card and are differentiable. hfft2/hfftn and their inverses are composed as
the reference composes them: the complex transform along the leading axes,
then the Hermitian one along the last (the inverse in the other order).
"""

from __future__ import annotations

import torch

from .framework.device import resolve_device
from .framework.dtypes import convert_dtype, default_float

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = ("backward", "ortho", "forward")


def _check_norm(norm):
    if norm is None:
        return "backward"
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    return norm


def _dims(axes):
    return None if axes is None else tuple(axes)


def _1d(torch_fn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        # torch's ihfft returns a lazily conjugated view: resolve it
        return torch_fn(x, n=n, dim=axis, norm=_check_norm(norm)
                        ).resolve_conj()
    op.__name__ = torch_fn.__name__
    op.__doc__ = f"torch.fft.{torch_fn.__name__} along `axis`."
    return op


def _2d(torch_fn):
    def op(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return torch_fn(x, s=s, dim=_dims(axes), norm=_check_norm(norm))
    op.__name__ = torch_fn.__name__
    op.__doc__ = f"torch.fft.{torch_fn.__name__} over `axes`."
    return op


def _nd(torch_fn):
    def op(x, s=None, axes=None, norm="backward", name=None):
        return torch_fn(x, s=s, dim=_dims(axes), norm=_check_norm(norm))
    op.__name__ = torch_fn.__name__
    op.__doc__ = f"torch.fft.{torch_fn.__name__} over `axes` (all: None)."
    return op


fft = _1d(torch.fft.fft)
ifft = _1d(torch.fft.ifft)
rfft = _1d(torch.fft.rfft)
irfft = _1d(torch.fft.irfft)
hfft = _1d(torch.fft.hfft)
ihfft = _1d(torch.fft.ihfft)

fft2 = _2d(torch.fft.fft2)
ifft2 = _2d(torch.fft.ifft2)
rfft2 = _2d(torch.fft.rfft2)
irfft2 = _2d(torch.fft.irfft2)
fftn = _nd(torch.fft.fftn)
ifftn = _nd(torch.fft.ifftn)
rfftn = _nd(torch.fft.rfftn)
irfftn = _nd(torch.fft.irfftn)


def _h2(fwd, axes_default=(-2, -1)):
    def op(x, s=None, axes=axes_default, norm="backward", name=None):
        norm = _check_norm(norm)
        ax = list(axes) if axes is not None else list(range(x.ndim))
        size = (lambda i: None) if s is None else (lambda i: s[i])
        out = x
        if fwd:
            for i, axis in enumerate(ax[:-1]):
                out = torch.fft.fft(out, n=size(i), dim=axis, norm=norm)
            return torch.fft.hfft(out, n=size(-1), dim=ax[-1], norm=norm)
        out = torch.fft.ihfft(out, n=size(-1), dim=ax[-1], norm=norm)
        for i, axis in enumerate(ax[:-1]):
            out = torch.fft.ifft(out, n=size(i), dim=axis, norm=norm)
        return out
    return op


hfft2 = _h2(True)
ihfft2 = _h2(False)
hfftn = _h2(True, axes_default=None)
ihfftn = _h2(False, axes_default=None)


def fftfreq(n, d=1.0, dtype=None, name=None, *, device=None):
    """The sample frequencies of an n-point transform with spacing d, in
    the default float dtype unless `dtype` says, on the default device
    unless `device` says."""
    return torch.fft.fftfreq(n, d=d, dtype=default_float() if dtype is None
                             else convert_dtype(dtype),
                             device=resolve_device(device))


def rfftfreq(n, d=1.0, dtype=None, name=None, *, device=None):
    return torch.fft.rfftfreq(n, d=d, dtype=default_float() if dtype is None
                              else convert_dtype(dtype),
                              device=resolve_device(device))


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=_dims(axes))


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=_dims(axes))

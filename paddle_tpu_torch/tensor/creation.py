"""Tensor creation. reference: paddle_tpu/tensor/creation.py (all of it)
and `to_tensor` (paddle_tpu/framework/core.py:943).

The port's tensor is `torch.Tensor`. A function that builds a tensor from
nothing puts it on the port's default device (CUDA unless `set_device`
says otherwise), or on the keyword-only `device`; a `_like` function or one
that takes a tensor keeps that tensor's device. Floating results default
to float32 and integer ones to int64, Paddle's defaults (the reference's
integers are int32 where JAX runs without 64-bit types).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.dtypes import convert_dtype, default_float

__all__ = [
    "to_tensor", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "arange", "linspace", "logspace", "eye", "empty",
    "empty_like", "tril", "triu", "diag", "diagflat", "meshgrid",
    "assign", "clone", "tril_indices", "triu_indices", "one_hot",
    "complex", "polar", "create_tensor",
]


def _dtype(dtype, default=None):
    """`dtype`, else `default`, else the default float dtype."""
    if dtype is not None:
        return convert_dtype(dtype)
    return default_float() if default is None else default


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _scalar(x):
    return x.item() if isinstance(x, torch.Tensor) else x


def _place(place):
    """A Paddle place ("gpu", "gpu:0", "cpu") or a torch device."""
    if isinstance(place, str) and place.startswith("gpu"):
        place = "cuda" + place[3:]
    return resolve_device(place)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A tensor holding `data` (a tensor, an array, a list or a scalar) on
    `place`. Without `dtype`, Python and numpy floats take the default
    float dtype (float32 unless set_default_dtype says otherwise) and
    integers int64; a tensor keeps its dtype. Gradients flow to a floating
    result when `stop_gradient` is False."""
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=_place(place) if place is not None
                             else data.device)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype.kind == "f":
            dtype = default_float()
        elif dtype is None and arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        t = torch.as_tensor(arr, device=_place(place))
    if dtype is not None:
        t = t.to(convert_dtype(dtype))
    t = t.clone() if isinstance(data, torch.Tensor) else t
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, name=None, *, device=None):
    return torch.zeros(_shape(shape), dtype=_dtype(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, name=None, *, device=None):
    return torch.ones(_shape(shape), dtype=_dtype(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, name=None, *, device=None):
    """`fill_value` everywhere: bool for a bool fill without `dtype`, else
    float32 by default."""
    fill_value = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        dtype = torch.bool
    return torch.full(_shape(shape), fill_value, dtype=_dtype(dtype),
                      device=resolve_device(device))


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_dtype(dtype, x.dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_dtype(dtype, x.dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _scalar(fill_value), dtype=_dtype(dtype,
                                                                 x.dtype))


def empty(shape, dtype=None, name=None, *, device=None):
    """Zeros, as the reference's."""
    return zeros(shape, dtype, device=device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, *,
           device=None):
    """[start, end) by step; int64 when all three are integers, else
    float32, unless `dtype` is given."""
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer)) for v in (start, end,
                                                                step))
        dtype = torch.int64 if ints else default_float()
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dtype(dtype),
                          device=resolve_device(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=_scalar(base), dtype=_dtype(dtype),
                          device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dtype(dtype),
                     device=resolve_device(device))


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x on the `offset` diagonal of a square matrix, the rest
    `padding_value`; a 2-D x's `offset` diagonal."""
    if x.dim() == 1:
        d = torch.diag(x, offset)
        if padding_value != 0:
            on = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            d = torch.where(torch.diag(on, offset), d,
                            torch.tensor(padding_value, dtype=x.dtype,
                                         device=x.device))
        return d
    return torch.diagonal(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


def assign(x, output=None):
    """A copy of x (a tensor, or an array or list put on the default
    device); written into `output` and returned when it is given."""
    src = x.detach().clone() if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(src)
        return output
    return src


def clone(x, name=None):
    return x.clone()


def tril_indices(row, col, offset=0, dtype="int64", *, device=None):
    r, c = np.tril_indices(row, offset, col)
    return torch.as_tensor(np.stack([r, c]), dtype=convert_dtype(dtype),
                           device=resolve_device(device))


def triu_indices(row, col=None, offset=0, dtype="int64", *, device=None):
    r, c = np.triu_indices(row, offset, row if col is None else col)
    return torch.as_tensor(np.stack([r, c]), dtype=convert_dtype(dtype),
                           device=resolve_device(device))


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows of x's ids."""
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


def complex(real, imag, name=None):
    return torch.complex(real, imag)


def polar(abs_, angle, name=None):
    return abs_ * torch.exp(1j * angle.to(torch.complex64))


def create_tensor(dtype, name=None, persistable=False, *, device=None):
    """An empty typed tensor to `assign` into."""
    return torch.zeros((0,), dtype=convert_dtype(dtype),
                       device=resolve_device(device))

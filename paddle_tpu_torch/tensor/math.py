"""Elementwise math, reductions and matrix products. reference:
paddle_tpu/tensor/math.py (all of it) and paddle_tpu/tensor/einsum.py.

Each op runs the reference's AMP cast hook under its name first
(amp._cast: `exp`, `log`, `mean`, `sum` are black ops, `matmul`, `addmm`
white). Dtypes follow the reference's promotion (JAX's, with Python
scalars weak): a Python scalar takes the tensor's dtype within its kind
(a float scalar with a bf16 tensor is rounded to bf16 first, as JAX's
weak typing does, where torch would compute with it in float32), an
integer tensor with a float scalar gives float32, and functions that are
only defined on floats (`exp`, `sqrt`, `logaddexp`, ...) take integer
inputs as float32. Integer sums and products are int64, as Paddle's; the
reference's are int32 because JAX runs without 64-bit types.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..amp import _cast
from ..framework.dtypes import convert_dtype

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _inexact(x):
    """x as a float tensor: integers and bools become float32."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x
    return x.to(torch.float32)


def _tensors(name, *args):
    """The tensor arguments through the AMP hook of `name`; the rest as
    they are."""
    idx = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    cast = _cast(name, *(args[i] for i in idx))
    out = list(args)
    for i, t in zip(idx, cast):
        out[i] = t
    return out


def _weak(value, other):
    """A Python scalar as a 0-d tensor beside tensor `other`, typed as
    JAX types a weak scalar: `other`'s dtype within the scalar's kind, else
    float32 for a float scalar (int64 for an int one, complex64 for a
    complex one)."""
    if isinstance(value, torch.Tensor):
        return value
    dt = other.dtype
    if isinstance(value, bool):
        want = dt
    elif isinstance(value, (int, np.integer)):
        want = dt if dt != torch.bool else torch.int64
    elif isinstance(value, (float, np.floating)):
        want = dt if (dt.is_floating_point or dt.is_complex) \
            else torch.float32
    else:
        want = dt if dt.is_complex else torch.complex64
    return torch.tensor(value, dtype=want, device=other.device)


def _pair(x, y):
    if not isinstance(x, torch.Tensor):
        x = _weak(x, y)
    if not isinstance(y, torch.Tensor):
        y = _weak(y, x)
    return x, y


def _unary(name, f, inexact=False):
    def op(x, name=None):
        (x,) = _cast(op.__name__, x)
        return f(_inexact(x) if inexact else x)
    op.__name__ = op.__qualname__ = name
    __all__.append(name)
    return op


def _binary(name, f, inexact=False, common=False):
    """`inexact`: integer inputs as float32; `common`: both inputs in their
    promoted dtype first (for torch functions that want one dtype)."""
    def op(x, y, name=None):
        x, y = _pair(*_tensors(op.__name__, x, y))
        if inexact:
            x, y = _inexact(x), _inexact(y)
        if common:
            dt = torch.result_type(x, y)
            x, y = x.to(dt), y.to(dt)
        return f(x, y)
    op.__name__ = op.__qualname__ = name
    __all__.append(name)
    return op


def _conj(a):
    return torch.conj_physical(a) if a.is_complex() else a


def _frac(a):
    return a - torch.trunc(a)


# ---- unary ----------------------------------------------------------------
abs = _unary("abs", torch.abs)
acos = _unary("acos", torch.acos, True)
acosh = _unary("acosh", torch.acosh, True)
asin = _unary("asin", torch.asin, True)
asinh = _unary("asinh", torch.asinh, True)
atan = _unary("atan", torch.atan, True)
atanh = _unary("atanh", torch.atanh, True)
ceil = _unary("ceil", torch.ceil)
cos = _unary("cos", torch.cos, True)
cosh = _unary("cosh", torch.cosh, True)
digamma = _unary("digamma", torch.special.digamma, True)
erf = _unary("erf", torch.erf, True)
erfinv = _unary("erfinv", torch.erfinv, True)
exp = _unary("exp", torch.exp, True)
expm1 = _unary("expm1", torch.expm1, True)
floor = _unary("floor", torch.floor)
frac = _unary("frac", _frac)
i0 = _unary("i0", torch.special.i0, True)
i0e = _unary("i0e", torch.special.i0e, True)
i1 = _unary("i1", torch.special.i1, True)
i1e = _unary("i1e", torch.special.i1e, True)
lgamma = _unary("lgamma", torch.lgamma, True)
log = _unary("log", torch.log, True)
log10 = _unary("log10", torch.log10, True)
log1p = _unary("log1p", torch.log1p, True)
log2 = _unary("log2", torch.log2, True)
neg = _unary("neg", torch.neg)
reciprocal = _unary("reciprocal", torch.reciprocal, True)
round = _unary("round", torch.round)
rsqrt = _unary("rsqrt", torch.rsqrt, True)
sigmoid = _unary("sigmoid", torch.sigmoid, True)
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin, True)
sinh = _unary("sinh", torch.sinh, True)
sqrt = _unary("sqrt", torch.sqrt, True)
square = _unary("square", torch.square)
tan = _unary("tan", torch.tan, True)
tanh = _unary("tanh", torch.tanh, True)
trunc = _unary("trunc", torch.trunc)
angle = _unary("angle", torch.angle, True)
conj = _unary("conj", _conj)
deg2rad = _unary("deg2rad", torch.deg2rad, True)
rad2deg = _unary("rad2deg", torch.rad2deg, True)


@_export
def logit(x, eps=None, name=None):
    """log(x / (1 - x)), x clipped to [eps, 1 - eps] first when eps is
    given and nonzero."""
    (x,) = _cast("logit", _inexact(x))
    if eps:
        x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


# ---- binary ---------------------------------------------------------------
def _ldexp(a, b):
    return a * torch.pow(2.0, b.to(torch.float32))


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)
remainder = _binary("remainder", torch.remainder)
floor_mod = _binary("floor_mod", torch.remainder)
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum, common=True)
minimum = _binary("minimum", torch.minimum, common=True)
fmax = _binary("fmax", torch.fmax, common=True)
fmin = _binary("fmin", torch.fmin, common=True)
atan2 = _binary("atan2", torch.atan2, True, True)
logaddexp = _binary("logaddexp", torch.logaddexp, True, True)
hypot = _binary("hypot", torch.hypot, True, True)
copysign = _binary("copysign", torch.copysign, True, True)
nextafter = _binary("nextafter", torch.nextafter, True, True)
ldexp = _binary("ldexp", _ldexp)
gcd = _binary("gcd", torch.gcd, common=True)
lcm = _binary("lcm", torch.lcm, common=True)
heaviside = _binary("heaviside", torch.heaviside, common=True)
inner = _binary("inner", torch.inner, common=True)
outer = _binary("outer", _outer, common=True)
kron = _binary("kron", torch.kron, common=True)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) and v.numel() == 1 else v


@_export
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x * scale + bias (bias_after_scale) or (x + bias) * scale, in x's
    dtype for a float x."""
    s, b = _scalar(scale), _scalar(bias)
    out = x * s + b if bias_after_scale else (x + b) * s
    return out.to(x.dtype) if x.dtype.is_floating_point else out


@_export
def clip(x, min=None, max=None, name=None):
    lo, hi = _scalar(min), _scalar(max)
    if lo is None and hi is None:
        return x.clone()
    return torch.clamp(x, lo, hi)


@_export
def lerp(x, y, weight, name=None):
    """x + weight * (y - x), the reference's formula (torch.lerp switches
    to y - (y - x) * (1 - weight) above 0.5)."""
    x, y = _pair(x, y)
    return x + weight * (y - x)


@_export
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = _cast("addmm", input, x, y)
    return beta * input + alpha * (x @ y)


@_export
def multiplex(inputs, index, name=None):
    """Row i of inputs[index[i]]."""
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(idx.numel(), device=idx.device)]


@_export
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@_export
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


# ---- reductions -----------------------------------------------------------
def _axis(axis, ndim):
    """A reduction's axes as a tuple (None: all of them)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, torch.Tensor):
        axis = axis.reshape(-1).tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % builtins.max(ndim, 1) for a in axis)
    return (int(axis) % builtins.max(ndim, 1),)


def _prod(a, dims, keepdim, dtype=None):
    for d in sorted(dims, reverse=True):
        a = torch.prod(a, d, keepdim=keepdim, dtype=dtype)
        dtype = None
    if not dims and dtype is not None:
        a = a.to(dtype)
    return a


def _logsumexp(a, dims, keepdim):
    a = _inexact(a)
    return torch.logsumexp(a, dims, keepdim=keepdim) if dims else a


def _mean(a, dims, keepdim, dtype=None):
    a = a if dtype is not None else _inexact(a)
    return torch.mean(a, dims, keepdim=keepdim, dtype=dtype)


def _nanmean(a, dims, keepdim):
    return torch.nanmean(_inexact(a), dims, keepdim=keepdim)


def _bool_all(f):
    def g(a, dims, keepdim):
        out = a if a.dtype == torch.bool else a != 0
        for d in sorted(dims, reverse=True):
            out = f(out, d, keepdim=keepdim)
        return out
    return g


def _reduction(name, f, takes_dtype=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        (x,) = _cast(op.__name__, x)
        dims = _axis(axis, x.dim())
        if x.dim() == 0:
            dims = ()
        dt = None if dtype is None else convert_dtype(dtype)
        if takes_dtype:
            return f(x, dims, keepdim, dt)
        out = f(x, dims, keepdim)
        return out if dt is None else out.to(dt)
    op.__name__ = op.__qualname__ = name
    __all__.append(name)
    return op


def _sum(a, dims, keepdim, dtype=None):
    return torch.sum(a, dims, keepdim=keepdim, dtype=dtype)


def _amax(a, dims, keepdim):
    return torch.amax(a, dims, keepdim=keepdim) if dims else a


def _amin(a, dims, keepdim):
    return torch.amin(a, dims, keepdim=keepdim) if dims else a


def _nansum(a, dims, keepdim, dtype=None):
    return torch.nansum(a, dims, keepdim=keepdim, dtype=dtype)


sum = _reduction("sum", _sum, True)
mean = _reduction("mean", _mean, True)
prod = _reduction("prod", _prod, True)
max = _reduction("max", _amax)
min = _reduction("min", _amin)
amax = _reduction("amax", _amax)
amin = _reduction("amin", _amin)
nansum = _reduction("nansum", _nansum, True)
nanmean = _reduction("nanmean", _nanmean)
all = _reduction("all", _bool_all(torch.all))
any = _reduction("any", _bool_all(torch.any))
logsumexp = _reduction("logsumexp", _logsumexp)


@_export
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return (x != 0).sum(_axis(axis, x.dim()), keepdim=keepdim)


def _flat_axis(x, axis):
    """x flattened with axis 0 for axis None, else (x, axis)."""
    return (x.reshape(-1), 0) if axis is None else (x, axis)


@_export
def cumsum(x, axis=None, dtype=None, name=None):
    x, ax = _flat_axis(x, axis)
    return torch.cumsum(x, ax, dtype=None if dtype is None
                        else convert_dtype(dtype))


@_export
def cumprod(x, dim=None, dtype=None, name=None):
    x, ax = _flat_axis(x, dim)
    return torch.cumprod(x, ax, dtype=None if dtype is None
                         else convert_dtype(dtype))


def _cum_extreme(f, x, axis, dtype):
    """(running extreme, the last index where x equals it), as the
    reference's scan computes them."""
    x, ax = _flat_axis(x, axis)
    vals = f(x, ax).values
    n = x.shape[ax]
    shape = [1] * x.dim()
    shape[ax] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    idx = torch.where(x == vals, ar, -1)
    idx = torch.cummax(idx, ax).values
    return vals, idx.to(convert_dtype(dtype))


@_export
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummax, x, axis, dtype)


@_export
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis, dtype)


def _halves(y, axis):
    n = y.shape[axis]
    return y.narrow(axis, 1, n - 1), y.narrow(axis, 0, n - 1)


@_export
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """Running integral of y by the trapezoid rule over `x`'s spacing (or
    dx, 1 by default)."""
    hi, lo = _halves(y, axis)
    d = torch.diff(x, dim=axis) if x is not None else (
        dx if dx is not None else 1.0)
    return torch.cumsum((hi + lo) / 2.0 * d, axis)


@_export
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=dx if dx is not None else 1.0, dim=axis)


@_export
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, prepend, append)


@_export
def dot(x, y, name=None):
    """The inner product of 1-D tensors, or of each row of 2-D ones."""
    return (x * y).sum(-1)


@_export
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _cast("matmul", x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


mm = matmul
__all__.append("mm")


@_export
def bmm(x, y, name=None):
    return torch.matmul(*_cast("bmm", x, y))


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *_cast("einsum", *operands))


__all__.append("einsum")

isfinite = _unary("isfinite", torch.isfinite)
isinf = _unary("isinf", torch.isinf)
isnan = _unary("isnan", torch.isnan)
isneginf = _unary("isneginf", torch.isneginf)
isposinf = _unary("isposinf", torch.isposinf)
isreal = _unary("isreal", torch.isreal)


@_export
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _pair(x, y)
    dt = torch.result_type(x, y)
    return torch.isclose(x.to(dt), y.to(dt), rtol, atol, equal_nan)


@_export
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor, as the reference's."""
    return isclose(x, y, rtol, atol, equal_nan).all()


@_export
def increment(x, value=1.0, name=None):
    """x += value, in place; returns x."""
    return x.add_(value)


@_export
def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the k largest scores, as a
    float32 0-d tensor."""
    topk = torch.topk(input, k, dim=-1).indices
    hit = (topk == label.reshape(-1, 1)).any(1)
    return hit.to(torch.float32).mean()

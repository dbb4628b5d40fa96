"""Tensor functions on `torch.Tensor`. reference: paddle_tpu/tensor/
(attribute, creation, extras, linalg, logic, math, manipulation, random,
search and stat, all of them) and the in-place family that
tensor/__init__.py:127-175 generates (`abs_`, `add_`, `clip_`, ...,
`where_`).

The reference also binds its functions and operators onto its own
`Tensor` class (`x.foo()` as `paddle.foo(x)`); the port's tensor stays
torch's, which is not patched, so they are exported as functions only.

An in-place function writes its result into its first argument and
returns that argument: `x.copy_(f(x, ...))`, or, where the result's shape
or dtype differs from x's (a comparison's bool, a cast, a transpose, a
broadcast), x rebound to the result as the reference rebinds it. Where
torch refuses an in-place write (a leaf that requires grad, under
autograd) the port raises torch's error; the reference, whose in-place
forms are rebinds, does not.
"""

from . import (attribute, creation, extras, linalg, logic, manipulation,
               math, random, search, stat)
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

import functools as _functools  # noqa: E402
import sys as _sys  # noqa: E402

import torch as _torch  # noqa: E402

_INPLACE_BASES = [
    "abs", "acos", "acosh", "addmm", "asin", "asinh", "atan", "atanh",
    "cosh", "erfinv", "lerp", "log1p", "not_equal", "put_along_axis",
    "bitwise_and", "bitwise_left_shift",
    "bitwise_not", "bitwise_or", "bitwise_right_shift", "bitwise_xor",
    "cast", "copysign", "cos", "cumprod", "cumsum", "digamma", "divide",
    "equal", "erf", "expm1", "floor_divide", "floor_mod", "frac", "gcd",
    "greater_equal", "greater_than", "hypot", "i0", "index_add",
    "index_put", "lcm", "ldexp", "less_equal", "less_than", "lgamma",
    "log", "log10", "log2", "logical_and", "logical_not", "logical_or",
    "logical_xor", "logit", "masked_fill", "mod", "multiply", "nan_to_num",
    "neg", "pow", "remainder", "scatter", "sin", "sinh", "square", "t",
    "tan", "tanh", "transpose", "tril", "triu", "trunc", "gammainc",
    "gammaincc", "gammaln", "multigammaln", "polygamma", "sinc", "renorm",
    "masked_scatter", "index_fill", "add", "subtract", "clip", "scale",
    "floor", "ceil", "exp", "sqrt", "rsqrt", "reciprocal", "round",
    "sigmoid",
]


def _write(x, out):
    """x holding `out`, in place where shape and dtype allow; returns x."""
    if out.shape == x.shape and out.dtype == x.dtype:
        return x.copy_(out)
    if _torch.is_grad_enabled() and x.requires_grad and x.is_leaf:
        raise RuntimeError("a leaf Variable that requires grad is being "
                           "used in an in-place operation.")
    x.data = out.detach()
    return x


def _gen_inplace():
    mod = _sys.modules[__name__]
    made = []
    for base in _INPLACE_BASES:
        fn = getattr(mod, base, None)
        name = base + "_"
        if fn is None or getattr(mod, name, None) is not None:
            continue

        def make(f):
            @_functools.wraps(f)
            def g(x, *a, **k):
                return _write(x, f(x, *a, **k))
            g.__qualname__ = g.__name__ = f.__name__ + "_"
            return g

        setattr(mod, name, make(fn))
        made.append(name)
    return made


_INPLACE = _gen_inplace()


shape_op = attribute.shape


def where_(condition, x, y=None, name=None):
    """x keeps its values where `condition`, and takes y's elsewhere."""
    return _write(x, manipulation.where(condition, x, y))


__all__ = list(dict.fromkeys(
    attribute.__all__ + creation.__all__ + logic.__all__
    + manipulation.__all__ + math.__all__ + search.__all__
    + linalg.__all__ + stat.__all__ + random.__all__ + extras.__all__
    + _INPLACE + ["where_", "shape_op"]))

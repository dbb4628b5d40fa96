"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller asks for
the CPU (`set_device("cpu")` or `device="cpu"`). Importing the package does
no work that needs a GPU; the CUDA kernels are built at first use
(ops/_build.py).
"""

__version__ = "0.1.0"

import builtins as _builtins  # noqa: E402

import torch as _torch  # noqa: E402

from . import (amp, generation, io, metric, models, nn,  # noqa: E402
               optimizer, regularizer, tensor, text, vision)
from . import linalg  # noqa: E402
from . import hapi  # noqa: E402
from . import (audio, autograd, device, fft, incubate, inference,  # noqa: E402
               jit, observability, ops, parallel, profiler, quantization,
               resilience, signal)
from . import distribution, geometric, sparse  # noqa: E402
from . import framework as base  # noqa: E402
from .amp import debugging as _debugging  # noqa: E402,F401
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: E402
                       no_grad, set_grad_enabled)
from .framework import (L1Decay, L2Decay, ParamAttr,  # noqa: E402
                        get_device, get_flags, load, save, seed, set_device,
                        set_flags)
from .framework.device import (CPUPlace, CUDAPinnedPlace,  # noqa: E402
                               CUDAPlace, TPUPlace, XPUPlace, device_count,
                               is_compiled_with_cuda, is_compiled_with_tpu,
                               is_compiled_with_xpu)
from .framework.dtypes import (bfloat16, complex64,  # noqa: E402
                               complex128, dtype, finfo, float8_e4m3fn,
                               float8_e5m2, float16, float32, float64,
                               get_default_dtype, iinfo, int8, int16, int32,
                               int64, set_default_dtype, uint8)
from .framework.dtypes import bool_ as bool8  # noqa: E402
from .framework.param_attr import Parameter  # noqa: E402
from .framework.random import (get_cuda_rng_state,  # noqa: E402
                               get_rng_state, set_cuda_rng_state,
                               set_rng_state)
from .hapi import Model, callbacks, flops, summary  # noqa: E402
from .nn.layer.layers import create_parameter  # noqa: E402
from .tensor import *  # noqa: E402,F401,F403
from .tensor import (attribute, creation, extras, logic,  # noqa: E402,F401
                     manipulation, math, random, search, stat)

bool = bool8  # noqa: A001 - paddle.bool, as the reference's
# paddle.dtype: the type of the dtype objects (for isinstance), not a call,
# so it stays out of __all__
EagerParamBase = Parameter

# the reference's top-level names beside its modules (paddle_tpu/__init__.py
# :80-225): the framework's surface
_TOP = ["grad", "no_grad", "enable_grad", "set_grad_enabled",
        "is_grad_enabled", "is_grad_enabled_", "bool", "bool8", "uint8",
        "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32",
        "float64", "complex64", "complex128", "float8_e4m3fn", "float8_e5m2",
        "set_default_dtype", "get_default_dtype", "finfo", "iinfo",
        "get_rng_state", "set_rng_state", "get_cuda_rng_state",
        "set_cuda_rng_state", "device_count", "CPUPlace", "CUDAPlace",
        "CUDAPinnedPlace", "TPUPlace", "XPUPlace", "is_compiled_with_cuda",
        "is_compiled_with_tpu", "is_compiled_with_xpu", "Parameter",
        "EagerParamBase", "in_dynamic_mode", "enable_static",
        "disable_static", "disable_signal_handler", "LazyGuard", "batch",
        "set_printoptions", "check_shape"]
_MODULES = ["autograd", "device", "fft", "signal", "audio", "jit",
            "inference", "profiler", "quantization", "resilience",
            "observability", "ops", "base", "incubate", "parallel",
            "attribute", "creation", "extras", "logic", "manipulation",
            "math", "random", "search", "stat", "distribution", "sparse",
            "geometric"]

# the port runs eagerly: static mode is a flag kept for the reference's
# API (jit.to_static stands where static graphs did)
_static_mode = [False]


def disable_static(place=None):
    _static_mode[0] = False


def enable_static():
    _static_mode[0] = True


def in_dynamic_mode():
    return not _static_mode[0]


def disable_signal_handler():
    """Paddle's C++ signal handlers: the port installs none."""


def is_grad_enabled_():
    return is_grad_enabled()


class LazyGuard:
    """Paddle's lazy parameter initialisation: the port's layers build
    their parameters where they are made, so the guard changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def batch(reader, batch_size, drop_last=False):
    """paddle.batch (the legacy reader API): a reader of lists of
    `batch_size` samples, the last one short unless drop_last."""
    def batched():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batched


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print: torch.set_printoptions with the given options."""
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems, sci_mode=sci_mode,
                                linewidth=linewidth).items() if v is not None}
    _torch.set_printoptions(**kw)


def check_shape(shape_v):
    """Raise ValueError unless `shape_v` is a tensor or a list of ints
    (each >= 0, or -1) and tensors."""
    if isinstance(shape_v, _torch.Tensor):
        return
    for s in shape_v:
        if isinstance(s, _torch.Tensor):
            continue
        if not isinstance(s, int) or isinstance(s, _builtins.bool) or (
                s < 0 and s != -1):
            raise ValueError(f"invalid dim {s!r} in shape {shape_v}")


__all__ = ["seed", "set_device", "get_device", "set_flags", "get_flags",
           "models", "generation", "optimizer", "nn", "amp", "io", "metric",
           "vision", "hapi", "callbacks", "regularizer", "Model", "summary",
           "flops", "save", "load", "ParamAttr", "L1Decay", "L2Decay",
           "tensor", "text", "create_parameter", "linalg"] + _TOP + \
    _MODULES + tensor.__all__

"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller asks for
the CPU (`set_device("cpu")` or `device="cpu"`). Importing the package does
no work that needs a GPU; the CUDA kernels are built at first use
(ops/_build.py).
"""

__version__ = "0.1.0"

from . import (amp, generation, io, metric, models, nn,  # noqa: E402
               optimizer, regularizer, tensor, text, vision)
from . import linalg  # noqa: E402
from . import hapi  # noqa: E402
from .framework import (L1Decay, L2Decay, ParamAttr,  # noqa: E402
                        get_device, get_flags, load, save, seed, set_device,
                        set_flags)
from .hapi import Model, callbacks, flops, summary  # noqa: E402
from .nn.layer.layers import create_parameter  # noqa: E402
from .tensor import *  # noqa: E402,F401,F403

__all__ = ["seed", "set_device", "get_device", "set_flags", "get_flags",
           "models", "generation", "optimizer", "nn", "amp", "io", "metric",
           "vision", "hapi", "callbacks", "regularizer", "Model", "summary",
           "flops", "save", "load", "ParamAttr", "L1Decay", "L2Decay",
           "tensor", "text", "create_parameter", "linalg"] + tensor.__all__

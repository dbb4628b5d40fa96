"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller asks for
the CPU (`set_device("cpu")` or `device="cpu"`). Importing the package does
no work that needs a GPU; the CUDA kernels are built at first use
(ops/_build.py).
"""

__version__ = "0.1.0"

from . import generation, models, optimizer  # noqa: E402
from .framework import (get_device, get_flags, seed,  # noqa: E402
                        set_device, set_flags)

__all__ = ["seed", "set_device", "get_device", "set_flags", "get_flags",
           "models", "generation", "optimizer"]

"""Device selection. reference: python/paddle/device/__init__.py set_device.

The port runs on the card: the default device is "cuda". The CPU is used
only when the caller asks for it, with `set_device("cpu")` or a
`device="cpu"` argument (the tests do). Asking for CUDA where there is none
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["set_device", "get_device", "resolve_device"]

_DEFAULT = ["cuda"]


def set_device(device) -> None:
    """Set the device that models and tensors are built on by default."""
    _DEFAULT[0] = str(torch.device(device))


def get_device() -> str:
    return _DEFAULT[0]


def resolve_device(device=None) -> torch.device:
    """The device to build on: `device` if given, else the default. Raises
    RuntimeError for a CUDA device when CUDA is unavailable."""
    dev = torch.device(device if device is not None else _DEFAULT[0])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' or call set_device('cpu') to run "
            "on the CPU")
    return dev

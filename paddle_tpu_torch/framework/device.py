"""Device selection and places. reference: paddle_tpu/framework/device.py
(`set_device`, `get_device`, the places, `device_count` and
`is_compiled_with_*`, :15-91).

The port runs on the card: the default device is "cuda". The CPU is used
only when the caller asks for it, with `set_device("cpu")` or a
`device="cpu"` argument (the tests do). Asking for CUDA where there is none
raises instead of carrying on on the CPU. Paddle's names take the place
of torch's where a user gives them: "gpu" and "gpu:1" are CUDA devices, and
a `Place` names its device. The port runs on no TPU or XPU:
`is_compiled_with_tpu()` is False here, where the reference says True.
"""

from __future__ import annotations

import torch

__all__ = ["set_device", "get_device", "resolve_device", "device_count",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "is_compiled_with_cuda", "is_compiled_with_xpu",
           "is_compiled_with_tpu", "cuda_device_count"]

_DEFAULT = ["cuda"]


class Place:
    """A device by kind ("cpu", "gpu", "tpu", "xpu") and index."""

    def __init__(self, kind: str, device_id: int = 0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"

    def __eq__(self, other):
        return isinstance(other, Place) and (self.kind, self.device_id) == (
            other.kind, other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def get_device_id(self) -> int:
        return self.device_id


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        super().__init__("gpu", device_id)


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a CPU place."""


class TPUPlace(Place):
    """Kept for the reference's API; the port runs on no TPU."""

    def __init__(self, device_id=0):
        super().__init__("tpu", device_id)


class XPUPlace(TPUPlace):
    pass


def _torch_device(device) -> torch.device:
    """A torch device from a torch device or name, Paddle's "gpu[:i]", or
    a Place (a GPU place is that CUDA device, a CPU place the CPU)."""
    if isinstance(device, Place):
        if device.kind == "cpu":
            return torch.device("cpu")
        if device.kind == "gpu":
            return torch.device("cuda", device.device_id)
        raise ValueError(f"{device!r}: the port runs on CUDA and the CPU")
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    return torch.device(device)


def set_device(device) -> None:
    """Set the device that models and tensors are built on by default."""
    _DEFAULT[0] = str(_torch_device(device))


def get_device() -> str:
    return _DEFAULT[0]


def resolve_device(device=None) -> torch.device:
    """The device to build on: `device` if given, else the default. Raises
    RuntimeError for a CUDA device when CUDA is unavailable."""
    dev = _torch_device(device if device is not None else _DEFAULT[0])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' or call set_device('cpu') to run "
            "on the CPU")
    return dev


def device_count() -> int:
    """The number of CUDA devices (0 without CUDA)."""
    return torch.cuda.device_count()


cuda_device_count = device_count


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    """False: the port runs on CUDA (the reference, on a TPU, says True)."""
    return False

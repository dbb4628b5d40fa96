"""paddle.version. reference: paddle_tpu/version/__init__.py
(full_version, major/minor/patch/rc, commit, and the cuda/cudnn/nccl/xpu/
tpu queries). The port's queries report the torch build it runs on:
`cuda()` is torch's CUDA version and `cudnn()` its cuDNN version ("False"
on a CPU-only build, as the reference says for a build without them);
`tpu()` names the accelerator the port runs on, the CUDA card, where the
reference names its TPU.
"""

from __future__ import annotations

full_version = "0.1.0"
major, minor, patch = (int(x) for x in full_version.split("."))
rc = 0
commit = "unknown"
istaged = False
with_pip_cuda_libraries = "OFF"

__all__ = ["full_version", "major", "minor", "patch", "rc", "commit",
           "show", "cuda", "cudnn", "nccl", "xpu", "tpu"]


def show():
    print(f"full_version: {full_version}")
    print(f"commit: {commit}")
    print(f"accelerator: {_accelerator()}")


def _accelerator():
    import torch
    if torch.cuda.is_available():
        return f"CUDA ({torch.cuda.get_device_name(0)})"
    return "CPU (no CUDA device)"


def cuda():
    import torch
    return torch.version.cuda or "False"


def cudnn():
    import torch
    v = torch.backends.cudnn.version() if torch.version.cuda else None
    return str(v) if v else "False"


def nccl():
    import torch
    try:
        v = torch.cuda.nccl.version()
    except Exception:  # noqa: BLE001 - a build without NCCL
        return "False"
    return ".".join(str(x) for x in v) if isinstance(v, tuple) else str(v)


def xpu():
    return "False"


def tpu():
    """The accelerator the port runs on: the CUDA card's name, or
    "unavailable" without one (the reference's answer when it finds no
    device)."""
    import torch
    try:
        return torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001
        return "unavailable"

"""paddle.sysconfig. reference: paddle_tpu/sysconfig.py (`get_include`,
`get_lib`): where the port's C and CUDA sources live (`csrc/`, the
headers a custom op may include) and where its native libraries are
built (`_build/`)."""

from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]

_ROOT = os.path.dirname(os.path.abspath(__file__))


def get_include():
    return os.path.join(_ROOT, "csrc")


def get_lib():
    return os.path.join(_ROOT, "_build")

"""The native parallel collate (csrc/collate.cc, a copy of the reference's
native/collate.cc `pt_collate_stack`), built by g++ at first use into
paddle_tpu_torch/_build/ and bound with ctypes, as ops/_build.py binds the
CUDA kernels. reference: paddle_tpu/_native/__init__.py (`collate_stack`,
`available`). Host code: where g++ is missing or the build fails,
`available()` is False and the loader stacks with numpy, as the
reference's does.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops._build import host_library

__all__ = ["available", "collate_stack"]

_LIB: list = []          # [CDLL] once built, [None] once it failed
_LOCK = threading.Lock()


def _build():
    target = host_library("collate.cc", "collate")
    lib = ctypes.CDLL(str(target))
    lib.pt_collate_stack.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int]
    lib.pt_collate_stack.restype = None
    return lib


def available() -> bool:
    """Whether the native collate is built (building it on first call)."""
    with _LOCK:
        if not _LIB:
            try:
                _LIB.append(_build())
            except (OSError, RuntimeError):
                _LIB.append(None)
    return _LIB[0] is not None


def collate_stack(arrays):
    """np.stack of equal-shaped arrays by the C++ threads (the interpreter
    lock released); np.stack itself where dtypes or shapes differ."""
    if not available() or len(arrays) < 2:
        return np.stack(arrays)
    if any(getattr(a, "dtype", None) != arrays[0].dtype for a in arrays):
        return np.stack(arrays)      # numpy's promotion rules
    a0 = np.ascontiguousarray(arrays[0])
    n = len(arrays)
    out = np.empty((n,) + a0.shape, a0.dtype)
    srcs = (ctypes.c_void_p * n)()
    holders = []
    for i, a in enumerate(arrays):
        ac = np.ascontiguousarray(a, dtype=a0.dtype)
        if ac.shape != a0.shape:
            return np.stack(arrays)
        holders.append(ac)
        srcs[i] = ac.ctypes.data_as(ctypes.c_void_p)
    _LIB[0].pt_collate_stack(srcs, n, a0.nbytes,
                             out.ctypes.data_as(ctypes.c_void_p), 0)
    return out

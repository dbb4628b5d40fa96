"""paddle.utils. reference: paddle_tpu/utils/__init__.py (`deprecated`,
`try_import`, `require_version`, `run_check`, and the `cpp_extension` and
`unique_name` modules)."""

from __future__ import annotations

import functools
import importlib
import warnings

from . import cpp_extension  # noqa: F401
from . import unique_name  # noqa: F401

__all__ = ["deprecated", "try_import", "require_version", "run_check",
           "cpp_extension", "unique_name"]


def deprecated(update_to="", since="", reason="", level=0):
    """A decorator that warns (DeprecationWarning) at each call, or raises
    RuntimeError at level 2."""
    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            msg = f"API {func.__module__}.{func.__name__} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f", use {update_to} instead"
            if reason:
                msg += f". reason: {reason}"
            if level == 2:
                raise RuntimeError(msg)
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)
        return wrapper
    return decorator


def try_import(module_name, err_msg=None):
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(err_msg or
                          f"{module_name} is required: {e}") from e


def require_version(min_version, max_version=None):
    """Raise unless min_version <= the package's version <= max_version
    (each compared as major.minor.patch)."""
    from .. import __version__

    def to_tuple(v):
        return tuple(int(x) for x in str(v).split(".")[:3])

    cur = to_tuple(__version__)
    if to_tuple(min_version) > cur:
        raise Exception(
            f"installed version {__version__} < required {min_version}")
    if max_version and to_tuple(max_version) < cur:
        raise Exception(
            f"installed version {__version__} > maximum {max_version}")


def run_check():
    """Check that the default device works: a 128 x 128 float32 product of
    ones on it, its checksum printed (128 * 128 * 128 = 2097152)."""
    import torch

    from ..framework.device import resolve_device
    d = resolve_device(None)
    x = torch.ones((128, 128), dtype=torch.float32, device=d)
    y = x @ x
    name = (torch.cuda.get_device_name(d) if d.type == "cuda"
            else d.type)
    print(f"PaddleTPU works on {d.type}:{name}. "
          f"matmul checksum {float(y.sum()):.0f}")

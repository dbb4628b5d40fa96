"""Dtypes. reference: paddle_tpu/framework/dtypes.py: the dtype objects
(here torch's own), the names they go by, the default float dtype
(`set_default_dtype`/`get_default_dtype`), and `finfo`/`iinfo`
(reference: paddle_tpu/__init__.py:165-175)."""

from __future__ import annotations

import torch

__all__ = ["NAME2DTYPE", "convert_dtype", "rounded", "dtype", "bool_",
           "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
           "float32", "float64", "complex64", "complex128", "float8_e4m3fn",
           "float8_e5m2", "set_default_dtype", "get_default_dtype",
           "dtype_name", "finfo", "iinfo"]

dtype = torch.dtype
bool_ = torch.bool
uint8, int8, int16, int32, int64 = (torch.uint8, torch.int8, torch.int16,
                                    torch.int32, torch.int64)
float16, bfloat16, float32, float64 = (torch.float16, torch.bfloat16,
                                       torch.float32, torch.float64)
complex64, complex128 = torch.complex64, torch.complex128
float8_e4m3fn, float8_e5m2 = torch.float8_e4m3fn, torch.float8_e5m2

NAME2DTYPE = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "fp64": torch.float64,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

# the float dtype of creation and random functions called without one
_DEFAULT_FLOAT = [torch.float32]


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return NAME2DTYPE[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def set_default_dtype(d) -> None:
    """paddle.set_default_dtype: the float dtype that creation and random
    functions give without a `dtype` (float16, bfloat16, float32 or
    float64)."""
    d = convert_dtype(d)
    if not d.is_floating_point:
        raise TypeError(f"set_default_dtype takes a float dtype, got {d}")
    _DEFAULT_FLOAT[0] = d


def get_default_dtype() -> str:
    """The default float dtype's name, as Paddle gives it ("float32")."""
    return dtype_name(_DEFAULT_FLOAT[0])


def default_float() -> torch.dtype:
    return _DEFAULT_FLOAT[0]


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).removeprefix("torch.")


def finfo(dtype):
    """torch.finfo of a float dtype or its name (bits, eps, min, max, tiny,
    resolution, ...; the reference gives jnp.finfo's)."""
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    """torch.iinfo of an integer dtype or its name (bits, min, max)."""
    return torch.iinfo(convert_dtype(dtype))


def rounded(x: float, dtype) -> float:
    """A Python scalar as `dtype` holds it. The reference's arithmetic of
    a bf16 array with a Python float rounds the float to bf16 first
    (JAX's weak typing); torch computes with it in float32, so the port
    rounds it here where that differs."""
    return torch.tensor(x, dtype=convert_dtype(dtype)).item()

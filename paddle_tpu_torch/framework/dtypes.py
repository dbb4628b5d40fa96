"""Dtype names to torch dtypes. reference: paddle_tpu/framework/dtypes.py
(the names that `LlamaConfig.dtype` and `jit.InputSpec` take)."""

from __future__ import annotations

import torch

__all__ = ["NAME2DTYPE", "convert_dtype"]

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
}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return NAME2DTYPE[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None

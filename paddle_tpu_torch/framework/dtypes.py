"""Dtype names to torch dtypes. reference: paddle_tpu/framework/dtypes.py
(the names that `LlamaConfig.dtype` takes)."""

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
}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return NAME2DTYPE[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None

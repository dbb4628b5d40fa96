"""Tensor attribute queries. reference: paddle_tpu/tensor/attribute.py
(`rank`, `shape`, `is_complex`, `is_floating_point`, `is_integer`; `real`
and `imag` from tensor/math.py, `is_tensor` from tensor/logic.py).

`rank` and `shape` are int32 tensors on x's device, as the reference's
(int32 there because JAX runs without 64-bit types)."""

from __future__ import annotations

import torch

__all__ = ["rank", "shape", "is_complex", "is_floating_point", "is_integer",
           "real", "imag", "is_tensor"]


def rank(input):
    return torch.tensor(input.dim(), dtype=torch.int32, device=input.device)


def shape(input):
    return torch.tensor(tuple(input.shape), dtype=torch.int32,
                        device=input.device)


def is_complex(x):
    return x.is_complex()


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def real(x, name=None):
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def is_tensor(x):
    return isinstance(x, torch.Tensor)

"""Common functionals in Paddle's layouts. reference:
paddle_tpu/nn/functional/common.py (`linear` :26, `dropout` :34,
`embedding` :77)."""

from __future__ import annotations

import torch

from ...amp import _cast
from ...framework.random import get_generator

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W shaped (in, out), Paddle's layout."""
    x, weight, bias = _cast("linear", x, weight, bias)
    out = x @ weight
    return out if bias is None else out + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability p, drawn from the port's generator
    of x's device (framework.random). `axis` (an int or a list) draws one
    mask over those axes, broadcast over the rest. "upscale_in_train"
    scales the kept elements by 1 / (1 - p); "downscale_in_infer" keeps them
    as they are. Outside training or at p = 0, x itself."""
    if not training or p == 0.0:
        return x
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode={mode!r}; pick upscale_in_train or "
                         f"downscale_in_infer")
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in
                (axis if isinstance(axis, (list, tuple)) else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.empty(shape, dtype=torch.float32, device=x.device)
    keep = keep.bernoulli_(1.0 - p, generator=get_generator(x.device)) > 0
    if mode == "upscale_in_train":
        x = x / (1.0 - p)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` (num_embeddings, dim) at integer ids `x`; rows at
    `padding_idx` are zero. `sparse` asks Paddle for a sparse gradient; the
    reference accepts it and ignores it, and so does the port."""
    out = weight[x]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out

"""reference: paddle_tpu/parallel/functional.py:112 split_stacked_layer_params."""

from __future__ import annotations

import re

import torch

__all__ = ["split_stacked_layer_params"]


def split_stacked_layer_params(state: dict,
                               pattern: str = r"^llama\.layers\.(\d+)\.(.+)$"):
    """Split a name->tensor state dict into (stacked, other): tensors whose
    names match `pattern` are grouped by suffix and stacked on a new leading
    layer dim (L, ...) in layer order; everything else passes through.
    Stacking copies: at 7B it doubles the weights' memory, so the generate
    path loops over per-layer parameters instead."""
    rx = re.compile(pattern)
    per_layer: dict = {}
    other: dict = {}
    for k, v in state.items():
        m = rx.match(k)
        if m:
            per_layer.setdefault(m.group(2), []).append((int(m.group(1)), v))
        else:
            other[k] = v
    stacked = {name: torch.stack([v for _, v in sorted(items,
                                                       key=lambda x: x[0])])
               for name, items in per_layer.items()}
    return stacked, other

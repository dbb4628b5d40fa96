"""ASP: automatic semi-structured (n:m, 2:4 by default) sparsity.
reference: paddle_tpu/incubate/asp.py (`_to_rows` :45, `_mask_rows_1d`
:66, `create_mask` :86, `prune_model` :118, `decorate` :173).

The mask keeps the n largest |w| of every m consecutive weights along the
rows `_to_rows` makes: a 2-D weight as it is, so for a Linear weight (in,
out) the groups run along its last axis (out). Masks are built on the
weight's device from a float32 copy (a bf16 weight too) by a stable sort
of each group: on an exact tie of |w| the lower index is dropped first,
where the reference's numpy argsort may drop either. `prune_model`
multiplies each supported layer's weight by its mask in place and keeps
the mask on the parameter (`_asp_mask`); `decorate` wraps an optimizer so
that every `step()` multiplies each masked parameter by its mask again, in
place under no_grad.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import nn

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "create_mask", "check_mask_1d", "check_mask_2d", "check_sparsity"]

_excluded = set()


def _torch(x):
    """(a torch tensor of `x`, whether `x` came as one)."""
    if isinstance(x, torch.Tensor):
        return x.detach(), True
    return torch.as_tensor(np.asarray(x)), False


def calculate_density(x):
    """The fraction of nonzero entries."""
    t, _ = _torch(x)
    return float(torch.count_nonzero(t)) / max(t.numel(), 1)


def set_excluded_layers(param_names, main_program=None):
    for n in (param_names if isinstance(param_names, (list, tuple))
              else [param_names]):
        _excluded.add(n)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def _to_rows(w):
    """The reference's orientation: the weight as rows whose groups of m
    get the mask, and the map back. 1-D -> (1, d); 2-D as it is; 3-D ->
    (d0 d1, d2); 4-D (a, b, c, d) -> (a b d, c)."""
    shape = tuple(w.shape)
    if w.dim() == 1:
        return w.reshape(1, -1), lambda mk: mk.reshape(shape)
    if w.dim() == 2:
        return w, lambda mk: mk
    if w.dim() == 3:
        return (w.reshape(shape[0] * shape[1], shape[2]),
                lambda mk: mk.reshape(shape))
    if w.dim() == 4:
        t = w.permute(0, 1, 3, 2).reshape(
            shape[0] * shape[1] * shape[3], shape[2])
        return t, lambda mk: mk.reshape(
            shape[0], shape[1], shape[3], shape[2]).permute(0, 1, 3, 2)
    raise ValueError(f"create_mask supports ndim<=4, got {w.dim()}")


def _mask_rows_1d(t2d, n, m):
    """The n:m pattern along each row, rows zero-padded to a multiple of
    m: the m - n smallest |w| of each group dropped (a stable sort)."""
    rows, cols = t2d.shape
    pad = (-cols) % m
    if pad:
        t2d = torch.cat([t2d, t2d.new_zeros((rows, pad))], 1)
    flat = t2d.reshape(-1, m)
    drop = torch.argsort(flat.abs(), dim=1, stable=True)[:, :m - n]
    mask = torch.ones_like(flat).scatter_(1, drop, 0.0)
    return mask.reshape(rows, cols + pad)[:, :cols]


def create_mask(weight, func_name="mask_1d", n=2, m=4):
    """The n:m mask of `weight` (keep the n largest of every m consecutive
    weights along the rows), in its dtype: a tensor on its device for a
    tensor, a numpy array for an array."""
    w, is_tensor = _torch(weight)
    t2d, restore = _to_rows(w.float())
    mask = restore(_mask_rows_1d(t2d, n, m)).to(w.dtype)
    return mask if is_tensor else mask.numpy()


def check_mask_1d(mat, n=2, m=4):
    """Every group of m along each row (zero-padded) holds at most n
    nonzeros."""
    a, _ = _torch(mat)
    if a.dim() == 1:
        a = a.reshape(1, -1)
    pad = (-a.shape[-1]) % m
    if pad:
        a = torch.cat([a, a.new_zeros(tuple(a.shape[:-1]) + (pad,))], -1)
    groups = (a != 0).reshape(-1, m).sum(1)
    return bool((groups <= n).all())


def check_mask_2d(mat, n=2, m=4):
    return check_mask_1d(mat, n, m)


def check_sparsity(mat, n=2, m=4, func_name=None):
    """check_mask_1d in the orientation create_mask writes."""
    a, _ = _torch(mat)
    t2d, _ = _to_rows(a)
    return check_mask_1d(t2d, n, m)


def _supported(layer):
    return isinstance(layer, (nn.Linear, nn.Conv2D))


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Mask every supported layer's weight (Linear, Conv2D) outside the
    excluded names, in place; returns {path: density}. With `with_mask`
    the mask stays on the parameter as `_asp_mask`."""
    pruned = {}

    @torch.no_grad()
    def prune_one(sub, path):
        mask = create_mask(sub.weight, mask_algo, n, m)
        sub.weight.mul_(mask)
        if with_mask:
            # on the parameter: it lives and dies with it, and the
            # decorated optimizer reads it after each step
            sub.weight._asp_mask = mask
        pruned[path] = calculate_density(sub.weight)

    def walk(layer, prefix=""):
        if _supported(layer) and prefix == "":
            prune_one(layer, "<root>")
            return
        for name, sub in layer.named_children():
            path = f"{prefix}.{name}" if prefix else name
            if _supported(sub) and path not in _excluded \
                    and sub.full_name() not in _excluded:
                prune_one(sub, path)
            else:
                walk(sub, path)

    walk(model)
    return pruned


class _MaskedOptimizer:
    """An optimizer that multiplies each masked parameter by its mask after
    every step, so pruned weights stay zero through fine-tuning."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def step(self):
        self._inner.step()
        with torch.no_grad():
            for p in getattr(self._inner, "_parameter_list", []) or []:
                mask = getattr(p, "_asp_mask", None)
                if mask is not None:
                    p.mul_(mask)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self._inner.clear_grad()


def decorate(optimizer):
    """Wrap `optimizer` so that masked weights stay pruned through its
    updates."""
    return _MaskedOptimizer(optimizer)

"""nn.utils. reference: paddle_tpu/nn/utils/__init__.py (all of it).

`weight_norm` replaces a layer's parameter `name` by `name_g` (its norm
over every axis but `dim`, or the whole norm when `dim` is None) and
`name_v` (its direction, the weight itself at first), and recomputes
`name` = v / ||v|| * g before each forward; `remove_weight_norm` turns the
last computed weight back into a parameter. `spectral_norm` divides
`name` by its largest singular value before each forward, through a
`SpectralNorm` sublayer `name_sn`."""

from __future__ import annotations

import torch
from torch import nn

from ..clip import clip_grad_norm_, clip_grad_value_  # noqa: F401
from ..layer.norm import SpectralNorm

__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "clip_grad_norm_",
           "clip_grad_value_"]


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Each parameter in turn takes its size of `vec`, in place."""
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n


def _norm_except(v, dim):
    if dim is None:
        return torch.linalg.norm(v)
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes))


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name).detach()
    layer.add_parameter(name + "_g", nn.Parameter(_norm_except(w, dim)))
    layer.add_parameter(name + "_v", nn.Parameter(w.clone()))
    del layer._parameters[name]

    def hook(lay, inputs):
        g, v = getattr(lay, name + "_g"), getattr(lay, name + "_v")
        if dim is None:
            w_ = v * (g / torch.linalg.norm(v))
        else:
            shape = [1] * v.dim()
            shape[dim] = -1
            norm = _norm_except(v, dim).reshape(shape)
            w_ = v / norm * g.reshape(shape)
        setattr(lay, name, w_)

    layer._wn_hook = layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    w = layer.__dict__.pop(name, None)
    if hasattr(layer, "_wn_hook"):
        layer._wn_hook.remove()
    layer._parameters.pop(name + "_g", None)
    layer._parameters.pop(name + "_v", None)
    if w is not None:
        layer.add_parameter(name, nn.Parameter(w.detach()))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    orig = layer._parameters[name]
    sn = SpectralNorm(tuple(orig.shape), dim=0 if dim is None else dim,
                      power_iters=n_power_iterations, epsilon=eps,
                      device=orig.device)
    layer.add_sublayer(name + "_sn", sn)

    def hook(lay, inputs):
        w_ = sn(orig)
        lay._parameters.pop(name, None)
        lay.__dict__[name] = w_

    layer._sn_hook = layer.register_forward_pre_hook(hook)
    return layer

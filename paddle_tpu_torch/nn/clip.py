"""Gradient clipping. reference: paddle_tpu/nn/clip.py (:18-118).

The clip objects take [(param, grad), ...] and return the same list with
new gradient tensors (the optimizers call them in `step`, so `p.grad` is
left as it was); `clip_grad_norm_` and `clip_grad_value_` rewrite
`p.grad` in place. Norms are taken in float32, and each gradient is
multiplied by the float32 scale in float32 and cast back to its own dtype,
as in the reference (a bf16 CUDA tensor times a float32 0-d CUDA tensor
would round the scale to bf16 first). The global norm adds the
per-gradient sums of squares one after another in the gradients' order,
the reference's order.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def _clip(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: g * min(clip_norm / ||g||, 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                n = g.float().square().sum().sqrt()
                scale = (self.clip_norm / n.clamp(min=1e-12)).clamp(max=1.0)
                g = (g.float() * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients together: g * clip_norm / max(||all||, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    @staticmethod
    def global_norm(grads):
        """sqrt of the sum of every gradient's float32 sum of squares,
        added in order (a float32 0-d tensor)."""
        total = None
        for g in grads:
            sq = g.float().square().sum()
            total = sq if total is None else total + sq
        return total.sqrt()

    def _clip(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        gn = self.global_norm(grads)
        scale = self.clip_norm / gn.clamp(min=self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def _params(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every `p.grad` in place by min(max_norm / (norm + 1e-6), 1),
    the norm of order `norm_type` over all of them in float32; returns the
    norm. `error_if_nonfinite` is accepted and ignored, as the reference
    does."""
    grads = [p.grad for p in _params(parameters) if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        n = torch.stack([g.abs().max() for g in grads]).max().float()
    else:
        n = torch.stack([g.float().abs().pow(norm_type).sum()
                         for g in grads]).sum() ** (1.0 / norm_type)
    scale = (max_norm / (n + 1e-6)).clamp(max=1.0)
    for g in grads:
        g.copy_(g.float() * scale)
    return n


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in _params(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)

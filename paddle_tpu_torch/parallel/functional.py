"""Functional pieces of the training step. reference:
paddle_tpu/parallel/functional.py — `functional_call` (:21),
`split_stacked_layer_params` (:112), `rmsnorm_lm_loss` (:136) and
`rmsnorm_lm_loss_chunked` (:149).
"""

from __future__ import annotations

import re

import torch
from torch.utils.checkpoint import checkpoint

from ..nn.functional import rms_norm

__all__ = ["functional_call", "split_stacked_layer_params",
           "rmsnorm_lm_loss", "rmsnorm_lm_loss_chunked"]


def functional_call(model, params: dict, *args, training=True, **kwargs):
    """Run model(*args, **kwargs) with the tensors of `params` (name ->
    tensor, `model.state_dict()` keys; names left out keep the model's own)
    in place of the model's parameters, through
    `torch.func.functional_call`. Autograd flows to the given tensors.
    training=False runs the model in eval mode and restores every
    submodule's own flag afterwards."""
    saved = None
    if not training and model.training:
        saved = [(m, m.training) for m in model.modules()]
        model.eval()
    try:
        return torch.func.functional_call(model, params, args, kwargs)
    finally:
        for m, was in saved or ():
            m.training = was


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


def rmsnorm_lm_loss(norm_w, proj_w_t, h, labels, eps):
    """Final RMSNorm -> projection -> next-token cross-entropy with an f32
    log-softmax over the whole (b, s - 1, vocab). proj_w_t: (hidden, vocab);
    pass embed_weight.T for tied embeddings."""
    logits = rms_norm(h, norm_w, eps) @ proj_w_t
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = lp.gather(-1, labels[:, 1:, None].long())[..., 0]
    return -picked.mean()


def _chunk_nll(x, y, proj_w_t):
    logits = (x @ proj_w_t).float()
    picked = logits.gather(-1, y[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum()


def rmsnorm_lm_loss_chunked(norm_w, proj_w_t, h, labels, eps,
                            chunk: int = 256):
    """`rmsnorm_lm_loss` over sequence chunks of `chunk` positions, each
    under `torch.utils.checkpoint`: only one chunk's (b, chunk, vocab)
    logits are live at a time, in the forward and again in the backward,
    which recomputes them chunk by chunk. The same math up to the order of
    the sum (nll = logsumexp - picked logit)."""
    x = rms_norm(h, norm_w, eps)[:, :-1]
    y = labels[:, 1:]
    b, n = y.shape
    total = None
    for c0 in range(0, n, chunk):
        part = checkpoint(_chunk_nll, x[:, c0:c0 + chunk],
                          y[:, c0:c0 + chunk], proj_w_t, use_reentrant=False)
        total = part if total is None else total + part
    return total / (b * n)

"""Functional pieces of the training step. reference:
paddle_tpu/parallel/functional.py — `functional_call` (:21),
`make_loss_fn` (:84), `split_stacked_layer_params` (:112),
`rmsnorm_lm_loss` (:136) and `rmsnorm_lm_loss_chunked` (:149).
"""

from __future__ import annotations

import re

import torch
from torch.utils.checkpoint import checkpoint

from ..framework.random import generator_scope
from ..nn.functional import rms_norm

__all__ = ["functional_call", "make_loss_fn", "split_stacked_layer_params",
           "rmsnorm_lm_loss", "rmsnorm_lm_loss_chunked"]


def functional_call(model, params: dict, *args, rng_key=None, training=True,
                    **kwargs):
    """Run model(*args, **kwargs) with the tensors of `params` (name ->
    tensor, `model.state_dict()` keys; names left out keep the model's own)
    in place of the model's parameters, through
    `torch.func.functional_call`. Autograd flows to the given tensors.
    `rng_key` (an int or a torch.Generator) is what dropout draws from
    inside the call (framework.random.generator_scope); without it, the
    port's generators. training=False runs the model in eval mode and
    restores every submodule's own flag afterwards."""
    saved = None
    if not training and model.training:
        saved = [(m, m.training) for m in model.modules()]
        model.eval()
    try:
        if rng_key is None:
            return torch.func.functional_call(model, params, args, kwargs)
        with generator_scope(rng_key):
            return torch.func.functional_call(model, params, args, kwargs)
    finally:
        for m, was in saved or ():
            m.training = was


def make_loss_fn(model, loss_fn=None, training=True):
    """pure loss(params, batch, rng_key) -> float32 scalar, for
    torch.func.grad and the like. `batch` is (x, y) or x alone. Without
    `loss_fn` the model is called with `labels=y` and returns the loss
    (or (loss, ...), the LM convention); with it, loss_fn(logits, y) of
    the model's output (its first element if a tuple). training=False
    runs the model in eval mode."""

    def pure_loss(params, batch, rng_key):
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            x, y = batch
        else:
            x, y = batch, None
        if loss_fn is None:
            out = functional_call(model, params, x, labels=y,
                                  rng_key=rng_key, training=training)
            loss = out[0] if isinstance(out, (tuple, list)) else out
        else:
            out = functional_call(model, params, x, rng_key=rng_key,
                                  training=training)
            logits = out[0] if isinstance(out, (tuple, list)) else out
            loss = loss_fn(logits, y)
        return loss.float()

    return pure_loss


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

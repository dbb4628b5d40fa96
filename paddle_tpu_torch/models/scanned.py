"""Stacked-parameter Llama loss for the training step. reference:
paddle_tpu/models/scanned.py (:26 `build_scanned_llama`).

The reference runs the decoder stack as one `lax.scan` over parameters
stacked on a leading layer dim, with `jax.checkpoint` on the layer body.
Here the scan is a Python loop over the layers and the checkpoint is
`torch.utils.checkpoint(..., use_reentrant=False)`. The params tree, its
names and the remat policies are the reference's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..framework.dtypes import convert_dtype
from ..parallel.functional import (functional_call, rmsnorm_lm_loss,
                                   rmsnorm_lm_loss_chunked,
                                   split_stacked_layer_params)

__all__ = ["build_scanned_llama", "REMAT_POLICIES"]

# the reference's names (jax.checkpoint_policies): "nothing" saves nothing
# and recomputes the whole layer, "everything" saves all (no recompute),
# "dots" saves only the matrix products' outputs
REMAT_POLICIES = ("dots", "everything", "nothing")
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_matmuls)


def build_scanned_llama(model, remat: bool = True, dtype=None,
                        remat_policy: str | None = None,
                        loss_chunk_mb: int = 256):
    """Split a LlamaForCausalLM's state into (embed, stacked layers, head)
    and return (params, loss_fn), loss_fn(params, ids, labels) being the
    scalar next-token LM loss.

    params = {"embed": {"weight"}, "layers": {name: (L, ...)},
    "head": {"norm", "lm_head"}}, "lm_head" absent when the embeddings are
    tied. The leaves are copies that require grad (cast to `dtype` if
    given). The layers run through `functional_call` on the model's first
    layer as a template, which never reads the model's own parameters, so
    a caller may free them (as tools/train_llama.py does). Per-layer
    recompute: remat=False or remat_policy
    "everything" saves every activation; remat=True with remat_policy None
    or "nothing" recomputes the whole layer in the backward; "dots" saves
    the matrix products' outputs and recomputes the rest. The loss takes
    the chunked path once the f32 (b, s, vocab) logits would exceed
    `loss_chunk_mb` MiB; `loss_fn.lm_loss_path` says which ran last.
    """
    if remat and remat_policy is not None and \
            remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r}; pick from "
                         f"{sorted(REMAT_POLICIES)}")
    cfg = model.config
    dt = None if dtype is None else convert_dtype(dtype)
    state = {k: v.to(dt) if dt is not None and v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    layers, other = split_stacked_layer_params(state)   # stacking copies
    other = {k: v.clone() for k, v in other.items()}
    params = {"embed": {"weight": other["llama.embed_tokens.weight"]},
              "layers": layers,
              "head": {"norm": other["llama.norm.weight"]}}
    tied = "lm_head.weight" not in other
    if not tied:
        params["head"]["lm_head"] = other["lm_head.weight"]
    del state, other
    for group in params.values():
        for leaf in group.values():
            leaf.requires_grad_(True)

    template = model.llama.layers[0]
    names = list(layers)
    eps = cfg.rms_norm_eps

    def layer(h, *weights):
        return functional_call(template, dict(zip(names, weights)), h)

    if not remat or remat_policy == "everything":
        body = layer
    elif remat_policy == "dots":
        def body(h, *weights):
            return checkpoint(layer, h, *weights, use_reentrant=False,
                              context_fn=_dots_context)
    else:
        def body(h, *weights):
            return checkpoint(layer, h, *weights, use_reentrant=False)

    def loss_fn(p, ids, labels):
        h = p["embed"]["weight"][ids]
        # one unbind per weight: its backward stacks the L per-layer grads
        # once (indexing layer i would write a full (L, ...) zero grad for
        # every layer)
        per_layer = zip(*(p["layers"][n].unbind(0) for n in names))
        for weights in per_layer:
            h = body(h, *weights)
        w = p["embed"]["weight"].T if tied else p["head"]["lm_head"]
        b, s = ids.shape
        if b * s * cfg.vocab_size * 4 > loss_chunk_mb * 1024 * 1024:
            loss_fn.lm_loss_path = "chunked"
            return rmsnorm_lm_loss_chunked(p["head"]["norm"], w, h, labels,
                                           eps)
        loss_fn.lm_loss_path = "fused"
        return rmsnorm_lm_loss(p["head"]["norm"], w, h, labels, eps)

    loss_fn.lm_loss_path = None
    return params, loss_fn

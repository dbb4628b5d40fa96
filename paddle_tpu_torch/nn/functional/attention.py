"""Attention functionals. reference: paddle_tpu/nn/functional/attention.py.

Layout (batch, seq, heads, head_dim). Without a mask the call goes to
`flash_attention_bshd`: the hand-written kernel for CUDA tensors, its plain
version for CPU tensors. The JAX package's per-shape router
(ops/pallas/attention_router.py) is not ported: its ledger holds TPU rows
only, and on CUDA the kernel is always taken. A mask takes the dense torch
math of the reference's `_xla_attention` (:27-45). Attention dropout is not
ported: the serving path never uses it.
"""

from __future__ import annotations

import torch

from ...ops.flash_attention import NEG_INF, flash_attention_bshd

__all__ = ["scaled_dot_product_attention"]


def _expand_kv(k, v, num_heads):
    """GQA on the dense path: repeat each kv head over its query heads."""
    rep = num_heads // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _dense_attention(q, k, v, bias=None, causal=False):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """query (b, sq, h, d); key/value (b, sk, kvh, d) with kvh dividing h;
    attn_mask an additive bias broadcastable to (b, h, sq, sk)."""
    if attn_mask is None:
        return flash_attention_bshd(query, key, value, causal=is_causal)
    k, v = _expand_kv(key, value, query.shape[2])
    return _dense_attention(query, k, v, bias=attn_mask, causal=is_causal)

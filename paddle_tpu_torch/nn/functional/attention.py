"""Attention functionals. reference: paddle_tpu/nn/functional/attention.py
(`_xla_attention` :27-45, `_expand_kv` :48, `_use_pallas` :65-91,
`scaled_dot_product_attention` :94, `sdp_kernel` :205-218).

Layout (batch, seq, heads, head_dim). On a CUDA device without a mask the
backend comes from `FLAGS_flash_attention_backend`: 'pallas' takes the
flash kernels (`flash_attention_bshd`), 'xla' the dense torch math, and
'auto' asks ops/attention_router for this shape. A mask, a dtype or head
dim the kernels do not take (under any backend), or a tensor off CUDA
takes the dense math, as the reference takes it off a TPU. Attention
dropout is not ported: the serving and training paths never use it.
"""

from __future__ import annotations

import torch

from ...framework import flags as _flags
from ...ops.flash_attention import NEG_INF, flash_attention_bshd, kernel_takes

__all__ = ["scaled_dot_product_attention", "sdp_kernel"]


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


def _use_pallas(q_shape, head_dim, has_bias, dtype=None, causal=True,
                device=None):
    """Whether attention of this shape takes the flash kernels: never with
    a bias/mask, off CUDA, or for a dtype or head dim the kernels do not
    take (float32, d > 128), even under a forced 'pallas' backend, where
    the reference's TPU kernel runs in any dtype; else
    FLAGS_flash_attention_backend, whose 'auto' asks the router."""
    if has_bias:
        # the kernels take no bias/mask: never select them silently
        return False
    backend = _flags.flag_value("flash_attention_backend")
    if backend == "xla":
        return False
    if device is None or torch.device(device).type != "cuda":
        return False
    dtype = torch.bfloat16 if dtype is None else dtype
    if not kernel_takes(dtype, head_dim):
        return False
    if backend == "pallas":
        return True
    from ...ops import attention_router as ar
    b, seq = q_shape[0], q_shape[1]
    heads = q_shape[2] if len(q_shape) > 3 else 1
    dec = ar.route(b * heads, seq, seq, head_dim, dtype, causal,
                   platform="cuda")
    return dec.fwd == "pallas"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """query (b, sq, h, d); key/value (b, sk, kvh, d) with kvh dividing h;
    attn_mask an additive bias broadcastable to (b, h, sq, sk)."""
    if _use_pallas(tuple(query.shape), query.shape[-1],
                   attn_mask is not None, dtype=query.dtype,
                   causal=is_causal, device=query.device):
        return flash_attention_bshd(query, key, value, causal=is_causal)
    k, v = _expand_kv(key, value, query.shape[2])
    return _dense_attention(query, k, v, bias=attn_mask, causal=is_causal)


class sdp_kernel:
    """Context manager that sets FLAGS_flash_attention_backend for its
    body: 'pallas' with enable_flash, else 'xla'."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        self.enable_flash = enable_flash

    def __enter__(self):
        self._prev = _flags.flag_value("flash_attention_backend")
        _flags.set_flags({"flash_attention_backend":
                          "pallas" if self.enable_flash else "xla"})
        return self

    def __exit__(self, *exc):
        _flags.set_flags({"flash_attention_backend": self._prev})
        return False

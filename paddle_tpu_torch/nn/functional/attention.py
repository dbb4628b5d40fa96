"""Attention functionals. reference: paddle_tpu/nn/functional/attention.py
(`_xla_attention` :27-45, `_expand_kv` :48, `_use_pallas` :65-91,
`scaled_dot_product_attention` :94-132, `flash_attention` :135,
`flash_attn_unpadded` :143-202, `sdp_kernel` :205-218).

Layout (batch, seq, heads, head_dim). On a CUDA device without a mask the
backend comes from `FLAGS_flash_attention_backend`: 'pallas' takes the
flash kernels (`flash_attention_bshd_higher_order`: K1, then K3/K4 or the
dense remat as routed, and under create_graph=True the dense forward's
backward, so gradients can be taken again), 'xla' the dense torch math, and
'auto' asks ops/attention_router for this shape. A mask, a dtype or head
dim the kernels do not take (under any backend), or a tensor off CUDA
takes the dense math, as the reference takes it off a TPU. So does
attention dropout (`dropout_p > 0` in training): the mask falls on the
probabilities, drawn from the port's generator of the tensors' device.
"""

from __future__ import annotations

import torch

from ...amp import _cast
from ...framework import flags as _flags
from ...framework.random import get_generator
from ...ops.flash_attention import (NEG_INF, flash_attention_bshd_higher_order,
                                   kernel_takes)

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sdp_kernel"]


def _expand_kv(k, v, num_heads):
    """GQA on the dense path: repeat each kv head over its query heads."""
    rep = num_heads // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _dense_attention(q, k, v, bias=None, causal=False, dropout_p=0.0):
    """Scores and softmax in f32; with dropout_p > 0 each probability is
    kept with probability 1 - dropout_p and scaled by 1 / (1 - dropout_p)
    (reference :39-42) before the cast to v's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.empty_like(probs).bernoulli_(
            1.0 - dropout_p, generator=get_generator(probs.device)) > 0
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


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
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """query (b, sq, h, d); key/value (b, sk, kvh, d) with kvh dividing h;
    attn_mask an additive bias broadcastable to (b, h, sq, sk). Dropout on
    the probabilities only when `training` and dropout_p > 0, and then on
    the dense path, as the reference's."""
    dropout_p = dropout_p if training else 0.0
    if dropout_p == 0.0 and _use_pallas(
            tuple(query.shape), query.shape[-1], attn_mask is not None,
            dtype=query.dtype, causal=is_causal, device=query.device):
        query, key, value = _cast("flash_attention_pallas", query, key,
                                  value)
        # second-order gradients through the kernel branch differentiate
        # the dense forward again (the reference's `_ho_fwd`, :105-120)
        return flash_attention_bshd_higher_order(query, key, value,
                                                 causal=is_causal)
    query, key, value, attn_mask = _cast("scaled_dot_product_attention",
                                         query, key, value, attn_mask)
    k, v = _expand_kv(key, value, query.shape[2])
    return _dense_attention(query, k, v, bias=attn_mask, causal=is_causal,
                            dropout_p=dropout_p)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, name=None, *, rng_name=""):
    """Paddle's flash_attention: (scaled_dot_product_attention's output,
    None). The reference returns None for the softmax whatever
    `return_softmax` is, and ignores `fixed_seed_offset` and `rng_name`:
    the dropout mask comes from the port's generator of the tensors'
    device. The sixth positional is `return_softmax`, as in both of the
    reference's definitions (nn/functional/common.py:288,
    nn/functional/attention.py:135)."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, *,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over packed (total_tokens, heads, head_dim) rows,
    sequence b holding rows cu_seqlens[b]:cu_seqlens[b + 1]. As the
    reference, the dense path: the rows are gathered into (batch,
    max_seqlen) blocks, each query sees its own sequence's keys (with
    `causal`, bottom-right aligned per sequence: query i of a sequence
    with lq queries and lk keys sees keys j <= i + lk - lq), and the
    outputs go back to the packed rows. Returns (out, None)."""
    dropout_p = dropout if training else 0.0
    mq, mk = int(max_seqlen_q), int(max_seqlen_k)
    dev = query.device
    cq, ck = cu_seqlens_q.long(), cu_seqlens_k.long()
    tq, tk = query.shape[0], key.shape[0]
    len_q, len_k = cq[1:] - cq[:-1], ck[1:] - ck[:-1]
    iq = cq[:-1, None] + torch.arange(mq, device=dev)[None]
    ik = ck[:-1, None] + torch.arange(mk, device=dev)[None]
    valid_q = torch.arange(mq, device=dev)[None] < len_q[:, None]
    valid_k = torch.arange(mk, device=dev)[None] < len_k[:, None]
    qb = query[iq.clamp(0, tq - 1)]
    kb = key[ik.clamp(0, tk - 1)]
    vb = value[ik.clamp(0, tk - 1)]
    logits = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * scale
    mask = valid_q[:, None, :, None] & valid_k[:, None, None, :]
    if causal:
        off = (len_k - len_q)[:, None, None, None]
        mask = mask & (torch.arange(mq, device=dev)[:, None] + off
                       >= torch.arange(mk, device=dev)[None, :])
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, -1).masked_fill(~mask, 0.0)
    if dropout_p > 0.0:
        keep = torch.empty_like(probs).bernoulli_(
            1.0 - dropout_p, generator=get_generator(dev)) > 0
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    outb = torch.einsum("bhqk,bkhd->bqhd", probs.to(value.dtype), vb)
    out = torch.zeros_like(query)
    rows = valid_q.reshape(-1)
    out = out.index_put((iq.reshape(-1)[rows],),
                        outb.reshape(-1, *outb.shape[2:])[rows])
    return out, None


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

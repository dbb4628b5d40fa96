"""Fused transformer functionals. reference:
paddle_tpu/incubate/nn/functional/__init__.py (`fused_rms_norm` :31-60,
`fused_rotary_position_embedding` :75-140, `swiglu` :143,
`fused_dot_product_attention` :186-193, `fused_attention_rms_epilogue`,
`_expand_gqa` and `_sdpa_dense` :196-258)."""

from __future__ import annotations

import torch

from ....nn.functional import scaled_dot_product_attention, silu
from ....nn.functional.attention import _dense_attention, _expand_kv

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding", "swiglu",
           "fused_dot_product_attention", "fused_attention_rms_epilogue"]


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None):
    """(optional residual and bias adds) -> RMSNorm over the last axis in
    f32, cast back to the input's dtype -> times norm_weight. With a
    residual, returns (out, the pre-norm sum). The reference takes
    norm_bias and begin_norm_axis and ignores them; here anything but
    their defaults raises."""
    if norm_bias is not None or begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError("fused_rms_norm normalizes the last axis "
                                  "and takes no norm_bias")
    a = x
    if residual is not None:
        a = a + residual
    if bias is not None:
        a = a + bias
    a32 = a.float()
    ms = torch.mean(a32 * a32, dim=-1, keepdim=True)
    out = (a32 * torch.rsqrt(ms + epsilon)).to(a.dtype)
    if norm_weight is not None:
        out = out * norm_weight
    if residual is not None:
        return out, a
    return out


def _sincos(seq, dim, base, dtype, device):
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                          # (seq, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)              # neox layout
    return emb.sin().to(dtype), emb.cos().to(dtype)


def fused_rotary_position_embedding(q, k=None, v=None, position_ids=None,
                                    rotary_emb_base=10000.0):
    """Neox-style RoPE on q/k/v of layout (batch, seq, heads, head_dim).
    The sin/cos table covers q's sequence; `position_ids` (batch, seq) picks
    rows of it. Returns a (q, k, v) tuple with None where None was given.
    The reference's explicit sin/cos inputs and interleaved style are not
    ported: Llama uses neither."""
    s, c = _sincos(q.shape[1], q.shape[-1], rotary_emb_base, q.dtype,
                   q.device)
    if position_ids is not None:
        s = s[position_ids][:, :, None, :]
        c = c[position_ids][:, :, None, :]
    else:
        s = s[None, :, None, :]
        c = c[None, :, None, :]

    def apply(x):
        if x is None:
            return None
        x1, x2 = x.chunk(2, dim=-1)
        return (x * c + torch.cat([-x2, x1], dim=-1) * s).to(x.dtype)

    return apply(q), apply(k), apply(v)


def swiglu(x, y=None):
    """silu(x) * y; y defaults to the second half of x."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return silu(x) * y


def fused_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                is_causal=False, training=True):
    """scaled_dot_product_attention, whose backend (flash kernels or dense)
    ops/attention_router picks per shape. Attention dropout is not
    ported: a dropout_p > 0 in training raises."""
    if training and dropout_p > 0.0:
        raise NotImplementedError("attention dropout is not ported")
    return scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                        is_causal=is_causal)


def fused_attention_rms_epilogue(q, k, v, residual, norm_weight,
                                 epsilon=1e-6, causal=True):
    """Attention with the rmsnorm(attn + residual) * weight epilogue.

    q/residual: (batch, seq, heads, head_dim); k/v GQA-native (kv heads
    dividing heads); norm_weight: (head_dim,): the norm axis is the head
    dim. On a CUDA device, where the router's ledger marks the fusion a
    winner at this shape, the epilogue runs inside the flash kernel's flush
    (K2, forward only); elsewhere, and always on the CPU, the same math
    runs as a dense torch composition (differentiable)."""
    from ....ops.attention_router import epilogue_fusion_wins
    b, s, h, d = q.shape
    if q.device.type == "cuda" and epilogue_fusion_wins(
            b * h, s, k.shape[1], d, q.dtype, causal):
        from ....ops.flash_attention import flash_attention_rms_epilogue_bshd
        return flash_attention_rms_epilogue_bshd(
            q, k, v, residual, norm_weight, causal=causal, eps=epsilon)
    kx, vx = _expand_gqa(k, v, h)
    return _rms_epilogue(_sdpa_dense(q, kx, vx, causal), residual,
                         norm_weight, epsilon)


def _rms_epilogue(att, residual, norm_weight, epsilon):
    """The unfused epilogue: rmsnorm(att + residual) * norm_weight over the
    last dim, the add in the inputs' dtype, the norm in f32, the result in
    att's dtype (reference :226-229)."""
    hh = (att + residual).float()
    ms = torch.mean(hh * hh, dim=-1, keepdim=True)
    return (hh * torch.rsqrt(ms + epsilon)
            * norm_weight.float()).to(att.dtype)


def _expand_gqa(k, v, num_heads):
    """(b, s, kvh, d) k/v -> (b, s, num_heads, d): each kv head repeated
    over its query heads."""
    return _expand_kv(k, v, num_heads)


def _sdpa_dense(q, k, v, causal):
    """Dense attention on (b, s, h, d) with k/v already expanded: f32
    scores, the -1e30 bottom-right causal mask, P in v's dtype."""
    return _dense_attention(q, k, v, causal=causal)

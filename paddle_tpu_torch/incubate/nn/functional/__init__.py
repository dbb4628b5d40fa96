"""Fused transformer functionals. reference:
paddle_tpu/incubate/nn/functional/__init__.py (`fused_rms_norm` :31-60,
`fused_layer_norm` :63, `fused_rotary_position_embedding` :75-140,
`swiglu` :143, `fused_linear` :154, `fused_linear_activation` :159,
`fused_bias_dropout_residual_layer_norm` :175,
`fused_dot_product_attention` :186-193, `fused_attention_rms_epilogue`,
`_expand_gqa` and `_sdpa_dense` :196-258, `fused_multi_head_attention`
:261, `_ln` :345, `fused_feedforward` :356, `masked_multihead_attention`
:408, `variable_length_memory_efficient_attention` :482,
`block_multihead_attention` :512, `fused_moe` :551, `fused_matmul_bias`
:572, `fused_bias_act` :589, `fused_dropout_add` :637, `blha_get_max_len`
:658, `fused_multi_transformer` :668).

The reference computes every op here but `fused_attention_rms_epilogue`
(K2 where the router picks it) as dense jnp outside any Pallas kernel, so
the port computes them as dense torch and none goes through the router.
`jax.nn.gelu` is the tanh approximation, so these ops' "gelu" is
F.gelu(approximate=True). Dropout draws from the port's generator of the
tensors' device (or from `seed` where the op takes one).

`masked_multihead_attention` and `block_multihead_attention` return the
updated cache, as the reference's; the port writes it in place, so the
returned cache is the input tensor (a departure by design: the reference
returns a new array and leaves its input as it was).
"""

from __future__ import annotations

import math

import torch

from ....amp import _cast
from ....framework.random import get_generator
from ....nn import functional as F
from ....nn.functional import scaled_dot_product_attention, silu
from ....nn.functional.attention import _dense_attention, _expand_kv
from ....ops.flash_attention import NEG_INF

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "swiglu", "fused_linear",
           "fused_linear_activation",
           "fused_bias_dropout_residual_layer_norm",
           "fused_dot_product_attention", "fused_multi_head_attention",
           "fused_feedforward", "masked_multihead_attention",
           "variable_length_memory_efficient_attention",
           "block_multihead_attention", "fused_moe",
           "fused_attention_rms_epilogue", "fused_matmul_bias",
           "fused_bias_act", "fused_dropout_add", "blha_get_max_len",
           "fused_multi_transformer"]


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kw):
    """(optional residual and bias adds) -> RMSNorm over the last axis in
    f32, cast back to the input's dtype -> times norm_weight. With a
    residual, returns (out, the pre-norm sum). The reference takes
    norm_bias, begin_norm_axis and quant_scale and ignores them; here
    anything but their defaults raises."""
    if norm_bias is not None or begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError("fused_rms_norm normalizes the last axis "
                                  "and takes no norm_bias")
    if quant_scale > 0:
        raise NotImplementedError("fused_rms_norm: int8 output quantization "
                                  "(quant_scale > 0) is not ported")
    a, res, b, w = _cast("rms_norm", x, residual, bias, norm_weight)
    if res is not None:
        a = a + res
    if b is not None:
        a = a + b
    a32 = a.float()
    ms = torch.mean(a32 * a32, dim=-1, keepdim=True)
    out = (a32 * torch.rsqrt(ms + epsilon)).to(a.dtype)
    if w is not None:
        out = out * w
    if residual is not None:
        return out, (x + residual if bias is None else x + residual + bias)
    return out


def _sincos(seq, dim, base, dtype, device, neox=True):
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                          # (seq, dim/2)
    emb = (torch.cat([freqs, freqs], dim=-1) if neox     # halves
           else freqs.repeat_interleave(2, dim=-1))      # interleaved pairs
    return emb.sin().to(dtype), emb.cos().to(dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """RoPE on q/k/v of layout (batch, seq, heads, head_dim): neox style
    (rotate halves) or, with use_neox_rotary_style=False, interleaved pairs.
    The sin/cos table is `sin`/`cos` (any shape ending in (seq, head_dim))
    when given, else built over q's sequence; `position_ids` (batch, seq)
    picks rows of it. Returns a (q, k, v) tuple with None where None was
    given. The reference takes `time_major` and ignores it (its layout is
    always batch-major); here time_major=True raises."""
    if time_major:
        raise NotImplementedError("fused_rotary_position_embedding: "
                                  "time_major=True is not ported")
    neox = use_neox_rotary_style
    if sin is not None:
        s = sin.reshape(sin.shape[-2], sin.shape[-1])
        c = cos.reshape(cos.shape[-2], cos.shape[-1])
    else:
        s, c = _sincos(q.shape[1], q.shape[-1], rotary_emb_base, q.dtype,
                       q.device, neox)
    if position_ids is not None:
        s = s[position_ids][:, :, None, :]
        c = c[position_ids][:, :, None, :]
    else:
        s = s[None, :, None, :]
        c = c[None, :, None, :]

    def rotate_half(x):
        if neox:
            x1, x2 = x.chunk(2, dim=-1)
            return torch.cat([-x2, x1], dim=-1)
        return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(
            x.shape)

    def apply(x):
        if x is None:
            return None
        return (x * c + rotate_half(x) * s).to(x.dtype)

    return apply(q), apply(k), apply(v)


def swiglu(x, y=None, name=None):
    """silu(x) * y; y defaults to the second half of x."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return silu(x) * y


def fused_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                is_causal=False, training=True, **kw):
    """scaled_dot_product_attention, whose backend (flash kernels or dense)
    ops/attention_router picks per shape. With dropout_p > 0 in training
    the dense path drops probabilities, drawn from the port's generator
    of the tensors' device, as nn.functional's does."""
    return scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                        dropout_p=dropout_p,
                                        is_causal=is_causal,
                                        training=training)


def fused_attention_rms_epilogue(q, k, v, residual, norm_weight,
                                 epsilon=1e-6, causal=True, name=None):
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


def _gelu(x):
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate=True)


def _ln(h, scale, bias, eps):
    """LayerNorm over the last axis with the population variance, in h's
    dtype (reference :345)."""
    var, mu = torch.var_mean(h, dim=-1, keepdim=True, correction=0)
    out = (h - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    """(optional residual and bias adds) -> LayerNorm over the last axis.
    With a residual, returns (out, the pre-norm sum)."""
    if residual is not None:
        x = x + residual
    if bias is not None:
        x = x + bias
    out = F.layer_norm(x, x.shape[-1], norm_weight, norm_bias, epsilon)
    if residual is not None:
        return out, x
    return out


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (each optionally transposed over its last two axes) + bias."""
    x, y, bias = _cast("fused_matmul_bias", x, y, bias)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    return out if bias is None else out + bias


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def _reversed(a):
    """jnp's `.T`: every axis reversed."""
    return a.permute(*range(a.dim() - 1, -1, -1))


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    """act(x @ y + bias) with act gelu (tanh form) or relu, anything else
    the identity, as the reference's."""
    x, y, bias = _cast("linear", x, y, bias)
    if trans_x:
        x = _reversed(x)
    if trans_y:
        y = _reversed(y)
    out = x @ y + bias
    if activation == "gelu":
        return _gelu(out)
    if activation == "relu":
        return torch.relu(out)
    return out


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """layer_norm(dropout(x + bias) + residual)."""
    out = x if bias is None else x + bias
    out = F.dropout(out, dropout_rate, training=training, mode=mode)
    out = out + residual
    return F.layer_norm(out, out.shape[-1], ln_scale, ln_bias, ln_epsilon)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, num_heads=-1,
                               transpose_qkv_wb=False, name=None):
    """One transformer attention block: (pre-)LN -> qkv projection ->
    attention (f32 scores, additive mask, dropout on the probabilities) ->
    output projection -> dropout -> residual add -> (post-)LN.

    x: (batch, seq, embed); qkv_weight: (3, heads, head_dim, embed), or
    (embed, 3 * embed) with transpose_qkv_wb; linear_weight: (embed,
    embed)."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention with cache_kv (incremental decode) "
            "is not supported; use masked_multihead_attention for the "
            "decode step")
    if transpose_qkv_wb and num_heads <= 0:
        raise ValueError(
            "fused_multi_head_attention: num_heads must be given (> 0) "
            "when transpose_qkv_wb=True (qkv_weight carries no head dim)")
    b, s, e = x.shape
    residual = h = x
    if pre_layer_norm:
        h = _ln(h, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    if transpose_qkv_wb:
        qkv = h @ qkv_weight                               # (b, s, 3e)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
        qkv = qkv.reshape(b, s, 3, num_heads, e // num_heads)
    else:
        qkv = torch.einsum("bse,thde->bsthd", h, qkv_weight)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (b, s, nh, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    probs = F.dropout(probs, attn_dropout_rate, training=training)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    out = ctx.reshape(b, s, -1) @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    out = F.dropout(out, dropout_rate, training=training)
    out = residual + out
    if not pre_layer_norm:
        out = _ln(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None):
    """The transformer FFN block: (pre-)LN -> linear1 -> activation (relu,
    gelu in its tanh form, swish/silu) -> dropout1 -> linear2 -> dropout2
    -> residual add -> (post-)LN."""
    act = {"relu": torch.relu, "gelu": _gelu, "swish": silu,
           "silu": silu}[activation]
    residual = h = x
    if pre_layer_norm:
        h = _ln(h, ln1_scale, ln1_bias, ln1_epsilon)
    h = h @ linear1_weight
    if linear1_bias is not None:
        h = h + linear1_bias
    h = act(h)
    h = F.dropout(h, dropout1_rate, training=training)
    h = h @ linear2_weight
    if linear2_bias is not None:
        h = h + linear2_bias
    h = F.dropout(h, dropout2_rate, training=training)
    if add_residual:
        h = residual + h
    if not pre_layer_norm:
        h = _ln(h, ln2_scale, ln2_bias, ln2_epsilon)
    return h


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """One decode step of multi-head attention against a KV cache.

    x: (batch, 3 * heads * head_dim), this step's packed q, k, v (plus
    `bias` of (3, heads, head_dim)); cache_kv: (2, batch, heads, max_len,
    head_dim); sequence_lengths: (batch, 1), the position this step's k/v
    are written at (0 without). Attends over positions <= it, f32 scores,
    plus `src_mask`. Returns (out (batch, heads * head_dim), cache_kv),
    the cache written in place."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    for unsupported, nm in ((beam_cache_offset, "beam_cache_offset"),
                            (qkv_out_scale, "qkv_out_scale"),
                            (out_shift, "out_shift"),
                            (out_smooth, "out_smooth"),
                            (cum_offsets, "cum_offsets"),
                            (rotary_tensor, "rotary_tensor")):
        if unsupported is not None:
            raise NotImplementedError(
                f"masked_multihead_attention: {nm} is not supported "
                "(apply fused_rotary_position_embedding to q/k before the "
                "call for RoPE)")
    if rotary_emb_dims:
        raise NotImplementedError(
            "masked_multihead_attention: in-kernel RoPE is not supported; "
            "apply fused_rotary_position_embedding to q/k first")
    _, b, nh, max_len, hd = cache_kv.shape
    qkv = x.reshape(b, 3, nh, hd)
    if bias is not None:
        qkv = qkv + bias[None]
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]     # (b, nh, hd)
    pos = (sequence_lengths.reshape(b).long() if sequence_lengths is not None
           else torch.zeros(b, dtype=torch.long, device=x.device))
    bi = torch.arange(b, device=x.device)
    cache_kv[0, bi, :, pos] = k_new.to(cache_kv.dtype)
    cache_kv[1, bi, :, pos] = v_new.to(cache_kv.dtype)
    keys, vals = cache_kv[0], cache_kv[1]                 # (b, nh, L, hd)
    logits = torch.einsum("bhd,bhld->bhl", q.float(), keys.float())
    logits = logits / math.sqrt(hd)
    valid = torch.arange(max_len, device=x.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
    if src_mask is not None:
        logits = logits + src_mask.reshape(b, 1, -1)[..., :max_len].float()
    probs = torch.softmax(logits, dim=-1).to(vals.dtype)
    out = torch.einsum("bhl,bhld->bhd", probs, vals)
    return out.reshape(b, nh * hd), cache_kv


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Attention on (batch, heads, seq, head_dim) with each batch row's
    keys cut at kv_seq_lens, dense with a length mask (f32 scores, the
    bottom-right causal mask, an additive `mask`)."""
    d, sq, sk = query.shape[-1], query.shape[2], key.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", query.float(), key.float())
    logits = logits * (scale if scale is not None else 1.0 / (d ** 0.5))
    kmask = torch.arange(sk, device=query.device)[None, :] < \
        kv_seq_lens.reshape(-1)[:, None]
    logits = logits.masked_fill(~kmask[:, None, None, :], NEG_INF)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=query.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits + mask
    p = torch.softmax(logits, dim=-1).to(value.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, value)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens,
                              block_tables, write_pos=None, num_heads=None,
                              num_kv_heads=None, name=None, **kwargs):
    """One decode step of attention over paged caches.

    qkv: (B, (H + 2 * KVH) * D), one new token a sequence; caches
    (num_blocks, block_size, KVH, D); block_tables (B, max_blocks);
    seq_lens (B,), lengths including the new token. Writes the new K/V at
    `write_pos` (default seq_lens - 1) in place and attends over the paged
    prefix (ops/paged_attention). Returns (out (B, H * D), key_cache,
    value_cache)."""
    from ....ops.paged_attention import (paged_attention_decode,
                                         write_to_cache)
    dropped = {k: v for k, v in kwargs.items() if v is not None}
    if dropped:
        raise NotImplementedError(
            "block_multihead_attention: unsupported reference arguments "
            f"{sorted(dropped)} would change numerics if ignored; apply "
            "rope/bias to qkv before calling (see "
            "fused_rotary_position_embedding)")
    kvh = key_cache.shape[2] if num_kv_heads is None else num_kv_heads
    d = key_cache.shape[3]
    B = qkv.shape[0]
    h = qkv.shape[1] // d - 2 * kvh
    q, k_new, v_new = torch.split(qkv.reshape(B, -1, d), [h, kvh, kvh],
                                  dim=1)
    pos = seq_lens - 1 if write_pos is None else write_pos
    kc, vc = write_to_cache(key_cache, value_cache, k_new, v_new,
                            block_tables, pos)
    out = paged_attention_decode(q, kc, vc, block_tables, seq_lens)
    return out.reshape(B, h * d), kc, vc


def fused_moe(x, gate_weight, expert_weights1, expert_bias1, expert_weights2,
              expert_bias2, quant_method="None", moe_topk=2,
              norm_topk_prob=True):
    """Dense mixture of experts: every token through every expert
    (gelu in its tanh form), weighted by the softmax gate's top-k
    (renormalized with norm_topk_prob) and zero elsewhere."""
    scores = torch.softmax(x @ gate_weight, dim=-1)
    topv, topi = torch.topk(scores, moe_topk, dim=-1)
    if norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(
        topi, expert_weights1.shape[0]).to(x.dtype)       # (..., k, E)
    gates = torch.einsum("...ke,...k->...e", onehot, topv)
    h = torch.einsum("...d,edh->...eh", x, expert_weights1) + expert_bias1
    out = torch.einsum("...eh,ehd->...ed", _gelu(h),
                       expert_weights2) + expert_bias2
    return torch.einsum("...ed,...e->...d", out, gates)


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None, smooth=None,
                   act_method="gelu", compute_dtype="default", quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0, quant_min_bound=0):
    """act(x [* dequant_scales in f32] + bias + shift) * smooth ... in the
    reference's order: dequantize, add bias, add shift, multiply smooth,
    then the activation (gelu in its tanh form, relu, silu, swiglu,
    geglu). The result is in `compute_dtype`, else float16 after a
    dequantization, else x's dtype."""
    acts = {"gelu": _gelu, "relu": torch.relu, "silu": silu,
            "swiglu": lambda a: silu(a[..., :a.shape[-1] // 2])
            * a[..., a.shape[-1] // 2:],
            "geglu": lambda a: _gelu(a[..., :a.shape[-1] // 2])
            * a[..., a.shape[-1] // 2:]}
    if act_method not in acts:
        raise ValueError(f"act_method must be one of {sorted(acts)}, got "
                         f"{act_method!r}")
    if quant_scale > 0:
        raise NotImplementedError(
            "fused_bias_act: int8 output quantization is not supported; "
            "use nn.quant / quantization for serving quant")
    dtypes = {"default": None, "fp16": torch.float16, "bf16": torch.bfloat16,
              "fp32": torch.float32}
    if compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be one of {sorted(dtypes)}, "
                         f"got {compute_dtype!r}")
    a = x
    if dequant_scales is not None:
        a = a.float() * dequant_scales
    if bias is not None:
        a = a + bias
    if shift is not None:
        a = a + shift
    if smooth is not None:
        a = a * smooth
    out = acts[act_method](a)
    want = dtypes[compute_dtype]
    if want is not None:
        return out.to(want)
    if dequant_scales is not None:
        return out.to(torch.float16)
    return out.to(x.dtype)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      seed=None, name=None):
    """dropout(x) + y; `seed` pins the mask (a generator seeded from it)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p) + y
        return x + y
    gen = None
    if seed is not None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=gen or get_generator(x.device)) > 0
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype) + y
    return torch.where(keep, x, 0.0).to(x.dtype) + y


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """(max encoder length, max decoder length), each of shape (1,)."""
    return (seq_lens_encoder.max().reshape(1),
            seq_lens_decoder.max().reshape(1))


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, residual_alpha=1.0, cache_kvs=None, beam_offset=None,
        pre_caches=None, seq_lens=None, rotary_embs=None, time_step=None,
        attn_mask=None, dropout_rate=0.0, rotary_emb_dims=0,
        activation="gelu", training=False, mode="upscale_in_train",
        trans_qkvw=True, ring_id=-1, name=None):
    """A stack of pre-LN transformer layers for inference: per layer,
    LN -> qkv projection (qkv_weights[i] (3, heads, head_dim, embed), or
    (embed, 3, heads, head_dim) with trans_qkvw=False) -> attention (f32
    scores, additive mask) -> output projection + residual * alpha -> LN ->
    FFN (gelu in its tanh form, or relu) + residual * alpha. Decode caches
    and the serving extras raise."""
    if training and dropout_rate > 0:
        raise NotImplementedError(
            "fused_multi_transformer: training-mode dropout is not "
            "supported (this is the inference-serving op)")
    for unsupported, nm in ((cache_kvs, "cache_kvs"),
                            (pre_caches, "pre_caches"),
                            (rotary_embs, "rotary_embs"),
                            (time_step, "time_step"),
                            (seq_lens, "seq_lens"),
                            (beam_offset, "beam_offset")):
        if unsupported is not None:
            raise NotImplementedError(
                f"fused_multi_transformer: {nm} is not supported; use "
                "paddle_tpu_torch.generation (KV-cache decode) or "
                "ops.paged_attention for serving caches")
    if not pre_layer_norm:
        raise NotImplementedError(
            "fused_multi_transformer: only pre_layer_norm=True (the "
            "reference default and the served configuration)")
    act = {"gelu": _gelu, "relu": torch.relu}.get(activation)
    if act is None:
        raise ValueError(f"activation must be gelu/relu, got {activation!r}")
    a = x
    for i in range(len(qkv_weights)):
        resid = a
        h = _ln(a, ln_scales[i], ln_biases[i], epsilon)
        eq = "bse,nhde->bsnhd" if trans_qkvw else "bse,enhd->bsnhd"
        qkv = torch.einsum(eq, h, qkv_weights[i]) + qkv_biases[i]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (
            q.shape[-1] ** 0.5)
        if attn_mask is not None:
            s = s + attn_mask
        p = torch.softmax(s, dim=-1).to(a.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", p, v)
        attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
        a = resid * residual_alpha + attn @ linear_weights[i] + \
            linear_biases[i]
        resid = a
        h = _ln(a, ffn_ln_scales[i], ffn_ln_biases[i], epsilon)
        h = act(h @ ffn1_weights[i] + ffn1_biases[i])
        a = resid * residual_alpha + h @ ffn2_weights[i] + ffn2_biases[i]
    return a

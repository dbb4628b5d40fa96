"""Fused transformer layers. reference: paddle_tpu/incubate/nn/layer.py
(`FusedLinear` :29, `FusedDropoutAdd` :48,
`FusedBiasDropoutResidualLayerNorm` :62, `FusedMultiHeadAttention` :85,
`FusedFeedForward` :169, `FusedTransformerEncoderLayer` :214, `FusedEcMoe`
:237, `FusedMultiTransformer` :266).

Parameter names, shapes and state-dict keys are the reference's, so
convert.load_reference_state carries a reference layer's weights across.
As the port's other layers, `weight_attr`-style parameters take an
initializer (or False to leave a bias out) and `dtype`/`device` are
keyword-only. "Fused" says what the reference's CUDA ops fuse; here, as in
the reference, each layer is a dense composition.
"""

from __future__ import annotations

import math

import torch

from ... import nn as pnn
from ...nn import functional as NF
from ...nn.initializer import Constant, XavierUniform
from ...nn.layer.common import _param
from . import functional as F
from ...nn.layer.layers import Layer

__all__ = ["FusedLinear", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer",
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedEcMoe"]


def _create(shape, attr=None, is_bias=False, default=None, dtype="float32",
            device=None):
    """The reference's create_parameter: None for attr False, else the
    initializer `attr`, `default`, or zeros for a bias and XavierUniform
    for a weight."""
    return _param(attr, default or (Constant(0.0) if is_bias
                                    else XavierUniform()),
                  shape, dtype, device)


class FusedLinear(Layer):
    """x @ weight + bias, weight (in, out), or (out, in) with
    transpose_weight."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 dtype="float32", device=None):
        super().__init__()
        self._transpose = transpose_weight
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        kw = dict(dtype=dtype, device=device)
        self.weight = _create(shape, weight_attr, **kw)
        self.bias = _create((out_features,), bias_attr, True, **kw)

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias,
                              transpose_weight=self._transpose)


class FusedDropoutAdd(Layer):
    """dropout(x) + y with the module's training flag."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self._p = p
        self._mode = mode

    def forward(self, x, y):
        return NF.dropout(x, self._p, training=self.training,
                          mode=self._mode) + y


class FusedBiasDropoutResidualLayerNorm(Layer):
    """layer_norm(dropout(x + linear_bias) + residual)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *,
                 dtype="float32", device=None):
        super().__init__()
        self._dropout = dropout_rate
        self._epsilon = epsilon
        kw = dict(dtype=dtype, device=device)
        self.ln_scale = _create((embed_dim,), weight_attr,
                                default=Constant(1.0), **kw)
        self.ln_bias = _create((embed_dim,), bias_attr, True, **kw)
        self.linear_bias = _create((embed_dim,), None, True, **kw)

    def forward(self, x, residual):
        h = NF.dropout(x + self.linear_bias, self._dropout,
                       training=self.training)
        return NF.layer_norm(h + residual, (int(self.ln_scale.shape[0]),),
                             self.ln_scale, self.ln_bias, self._epsilon)


class FusedMultiHeadAttention(Layer):
    """Self-attention with the pre- or post-LN and the residual:
    qkv_weight (3, heads, head_dim, embed), qkv_bias (3, heads, head_dim),
    linear_weight (embed, embed). A bool attn_mask keeps True and masks
    False; any other is added to the scores. Attention dropout falls on
    the probabilities."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, dtype="float32",
                 device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self._dropout = dropout_rate
        self._attn_dropout = attn_dropout_rate
        self._pre_ln = normalize_before
        self._epsilon = epsilon
        kw = dict(dtype=dtype, device=device)
        one = Constant(1.0)
        self.qkv_weight = _create((3, num_heads, self.head_dim, embed_dim),
                                  qkv_weight_attr, **kw)
        self.qkv_bias = _create((3, num_heads, self.head_dim),
                                qkv_bias_attr, True, **kw)
        self.linear_weight = _create((embed_dim, embed_dim),
                                     linear_weight_attr, **kw)
        self.linear_bias = _create((embed_dim,), linear_bias_attr, True,
                                   **kw)
        self.pre_ln_scale = _create((embed_dim,), pre_ln_scale_attr,
                                    default=one, **kw)
        self.pre_ln_bias = _create((embed_dim,), pre_ln_bias_attr, True,
                                   **kw)
        self.ln_scale = _create((embed_dim,), ln_scale_attr, default=one,
                                **kw)
        self.ln_bias = _create((embed_dim,), ln_bias_attr, True, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        x = residual = query
        if self._pre_ln:
            x = NF.layer_norm(x, (self.embed_dim,), self.pre_ln_scale,
                              self.pre_ln_bias, self._epsilon)
        B, S, D = x.shape
        qkv = torch.einsum("bsd,tnhd->tbsnh", x, self.qkv_weight) \
            + self.qkv_bias[:, None, None]
        q, k, v = qkv[0], qkv[1], qkv[2]                  # (B, S, H, hd)
        s = torch.einsum("bsnh,btnh->bnst", q, k) / math.sqrt(self.head_dim)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                s = s.masked_fill(~attn_mask, -1e30)
            else:
                s = s + attn_mask
        p = torch.softmax(s, dim=-1)
        p = NF.dropout(p, self._attn_dropout, training=self.training)
        o = torch.einsum("bnst,btnh->bsnh", p, v).reshape(B, S, D)
        out = o @ self.linear_weight + self.linear_bias
        out = NF.dropout(out, self._dropout, training=self.training)
        out = out + residual
        if not self._pre_ln:
            out = NF.layer_norm(out, (self.embed_dim,), self.ln_scale,
                                self.ln_bias, self._epsilon)
        return out


class FusedFeedForward(Layer):
    """The FFN block: linear1 -> activation (nn.functional's: gelu in its
    erf form) -> dropout -> linear2 -> dropout -> residual add, with norm1
    before it (normalize_before) or norm2 after it."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, dtype="float32",
                 device=None):
        super().__init__()
        self._pre_ln = normalize_before
        self._epsilon = epsilon
        self._dropout = dropout_rate
        self._act_dropout = (act_dropout_rate if act_dropout_rate is not None
                             else dropout_rate)
        self._act = activation
        kw = dict(dtype=dtype, device=device)
        self.linear1 = pnn.Linear(d_model, dim_feedforward,
                                  weight_attr=linear1_weight_attr,
                                  bias_attr=linear1_bias_attr, **kw)
        self.linear2 = pnn.Linear(dim_feedforward, d_model,
                                  weight_attr=linear2_weight_attr,
                                  bias_attr=linear2_bias_attr, **kw)
        # pre-LN normalizes the input with norm1, post-LN the residual sum
        # with norm2: two parameter sets, as in the reference's fused op
        self.norm1 = pnn.LayerNorm(d_model, epsilon=epsilon,
                                   weight_attr=ln1_scale_attr,
                                   bias_attr=ln1_bias_attr, **kw)
        self.norm2 = pnn.LayerNorm(d_model, epsilon=epsilon,
                                   weight_attr=ln2_scale_attr,
                                   bias_attr=ln2_bias_attr, **kw)

    def forward(self, src):
        residual = src
        x = self.norm1(src) if self._pre_ln else src
        act = getattr(NF, self._act)
        x = NF.dropout(act(self.linear1(x)), self._act_dropout,
                       training=self.training)
        x = NF.dropout(self.linear2(x), self._dropout, training=self.training)
        x = x + residual
        return x if self._pre_ln else self.norm2(x)


class FusedTransformerEncoderLayer(Layer):
    """FusedMultiHeadAttention then FusedFeedForward."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, dtype="float32",
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate if attn_dropout_rate
                               is not None else dropout_rate),
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedEcMoe(Layer):
    """Every token through every expert (gelu in its tanh form, or relu),
    weighted by the softmax of the gate's logits."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, *, dtype="float32",
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gate = pnn.Linear(hidden_size, num_experts, **kw)
        self.e1_w = _create((num_experts, hidden_size, inter_size), **kw)
        self.e1_b = _create((num_experts, 1, inter_size), is_bias=True,
                            **kw)
        self.e2_w = _create((num_experts, inter_size, hidden_size), **kw)
        self.e2_b = _create((num_experts, 1, hidden_size), is_bias=True,
                            **kw)
        self._act = act_type

    def forward(self, x, gate_logits=None):
        g = gate_logits if gate_logits is not None else self.gate(x)
        probs = torch.softmax(g, dim=-1)                   # (B, S, E)
        h = torch.einsum("bsd,edh->bseh", x, self.e1_w) + self.e1_b[:, 0]
        h = F._gelu(h) if self._act == "gelu" else torch.relu(h)
        o = torch.einsum("bseh,ehd->bsed", h, self.e2_w) + self.e2_b[:, 0]
        return torch.einsum("bsed,bse->bsd", o, probs)


class FusedMultiTransformer(Layer):
    """`num_layers` pre-LN FusedTransformerEncoderLayers. Incremental
    decode (caches, time_step) raises."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, qkv_weight_attrs=None, num_layers=-1,
                 nranks=1, ring_id=-1, name=None, *, dtype="float32",
                 device=None, **kw):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer supports pre-LN only (the reference "
                "kernel's layout)")
        if num_layers < 0:
            num_layers = len(qkv_weight_attrs) if qkv_weight_attrs else 1
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.layers = pnn.LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=True, dtype=dtype, device=device)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None, time_step=None,
                **kw):
        if caches is not None or time_step is not None:
            raise NotImplementedError(
                "FusedMultiTransformer: incremental decode (caches/"
                "time_step) is not implemented; use "
                "incubate.nn.functional.masked_multihead_attention for the "
                "decode step")
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=attn_mask)
        return out

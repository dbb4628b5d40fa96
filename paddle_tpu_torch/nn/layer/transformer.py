"""Transformer layers. reference: paddle_tpu/nn/layer/transformer.py (all
of it).

`MultiHeadAttention` projects q, k and v with `Linear`s, splits heads to
(batch, seq, heads, head_dim) and calls `F.scaled_dot_product_attention`,
so attention without a mask takes the flash kernels where the router
picks them, and a masked one (the decoder's causal `tgt_mask`, an additive
bias) the dense path, as in the reference. With a `cache` (k, v), the new
keys and values are appended to it and the updated cache is returned
beside the output.

As in the reference: `need_weights` is ignored (:29-35); the encoder and
decoder stacks ignore `cache` (:96, :123, :155, :189), so
`TransformerDecoder` has no incremental decoding; the stacks deep-copy one
layer (:118-119, :184-185), so every layer starts equal.
"""

from __future__ import annotations

import copy

import torch

from ...framework.device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = tuple
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, dtype="float32", device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        dd = {"dtype": dtype, "device": device}
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **dd)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **dd)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **dd)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **dd)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        sk = key.shape[1]
        q = self.q_proj(query).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, sk, self.num_heads, self.head_dim)
        v = self.v_proj(value).reshape(b, sk, self.num_heads, self.head_dim)
        if cache is not None:
            k = torch.cat([cache[0], k], 1)
            v = torch.cat([cache[1], v], 1)
            cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        return out if cache is None else (out, cache)

    def gen_cache(self, key, value=None, type=None):
        """An empty (k, v) cache, (batch, 0, heads, head_dim) each."""
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            dtype=key.dtype, device=key.device)
        return (empty, empty.clone())


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, dtype="float32", device=None):
        super().__init__()
        dd = {"dtype": dtype, "device": device}
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout if attn_dropout is None else attn_dropout,
            weight_attr=weight_attr, bias_attr=bias_attr, **dd)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **dd)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **dd)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(dropout if act_dropout is None
                                   else act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, dtype="float32", device=None):
        super().__init__()
        dd = {"dtype": dtype, "device": device}
        self.normalize_before = normalize_before
        ad = dropout if attn_dropout is None else attn_dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **dd)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **dd)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **dd)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **dd)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(dropout if act_dropout is None
                                   else act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = residual + self.dropout1(self.self_attn(tgt, tgt, tgt,
                                                      tgt_mask))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = residual + self.dropout2(self.cross_attn(tgt, memory, memory,
                                                       memory_mask))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        return out if self.norm is None else self.norm(out)


class Transformer(Layer):
    """An encoder stack and a decoder stack; with `normalize_before` each
    ends in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 dtype="float32", device=None):
        super().__init__()
        dd = {"dtype": dtype, "device": device}
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **dd), num_encoder_layers,
                LayerNorm(d_model, **dd) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **dd), num_decoder_layers,
                LayerNorm(d_model, **dd) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length, *, device=None):
        """(length, length) float32: 0 on and below the diagonal, -1e9
        above it, an additive mask. On the model's device unless
        `device` is given."""
        if device is None:
            p = next(self.named_parameters(), (None, None))[1]
            device = p.device if p is not None else resolve_device(None)
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=device).tril()
        return torch.where(keep, 0.0, -1e9)

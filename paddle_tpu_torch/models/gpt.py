"""GPT model family (GPT-3 style). reference: paddle_tpu/models/gpt.py.

Learned positions and a pre-LN transformer with causal attention through
`scaled_dot_product_attention` (on CUDA the router may take the K1 forward
and K3/K4 backward). Module and parameter names and Paddle's (in, out)
Linear layout follow the reference. Every module takes `device=`;
`GPTConfig.dtype` is the parameters' dtype. `generate` takes the
recompute path of `paddle_tpu_torch.generation`.
"""

from __future__ import annotations

import torch

from ..nn import Dropout, Embedding, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ._init import transformer_init_attr
from ..nn.layer.layers import Layer

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt3_1p3b"]


def _init_attr(config):
    # GPT-2 init: every weight matrix N(0, initializer_range), biases zero;
    # the Embedding N(0, 1) default would blow up the tied-softmax logits
    return transformer_init_attr(config.initializer_range)


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
                 num_attention_heads=16, intermediate_size=None,
                 max_position_embeddings=2048, layer_norm_eps=1e-5,
                 dropout=0.0, tie_word_embeddings=True,
                 initializer_range=0.02, *, dtype="float32"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.layer_norm_eps = layer_norm_eps
        self.dropout = dropout
        self.tie_word_embeddings = tie_word_embeddings
        self.initializer_range = initializer_range
        self.dtype = dtype


def _kw(config, device):
    return dict(dtype=config.dtype, device=device)


class GPTAttention(Layer):
    def __init__(self, config, *, device=None):
        super().__init__()
        h = config.hidden_size
        kw = dict(weight_attr=_init_attr(config), **_kw(config, device))
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout = config.dropout

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             dropout_p=self.dropout,
                                             training=self.training)
        return self.out_proj(out.reshape(b, s, self.num_heads
                                         * self.head_dim))


class GPTBlock(Layer):
    def __init__(self, config, *, device=None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(weight_attr=_init_attr(config), **_kw(config, device))
        self.ln_1 = LayerNorm(h, eps, **_kw(config, device))
        self.attn = GPTAttention(config, device=device)
        self.ln_2 = LayerNorm(h, eps, **_kw(config, device))
        self.fc1 = Linear(h, config.intermediate_size, **kw)
        self.fc2 = Linear(config.intermediate_size, h, **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = self.fc2(F.gelu(self.fc1(self.ln_2(x))))
        return x + self.dropout(h)


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, *, device=None):
        super().__init__()
        self.config = config
        kw = dict(weight_attr=_init_attr(config), **_kw(config, device))
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.h = LayerList([GPTBlock(config, device=device)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              **_kw(config, device))

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        x = self.wte(input_ids) + self.wpe(position_ids)
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    def __init__(self, config: GPTConfig, *, device=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, device=device)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size,
            weight_attr=_init_attr(config), bias_attr=False,
            **_kw(config, device))

    def forward(self, input_ids, position_ids=None, labels=None):
        """Logits (batch, seq, vocab); with `labels`, (loss, logits), the
        loss being the next-token cross-entropy: logits[:, t] predict
        labels[:, t + 1]."""
        hidden = self.gpt(input_ids, position_ids)
        if self.lm_head is not None:
            logits = self.lm_head(hidden)
        else:
            logits = F.linear(hidden, self.gpt.wte.weight.T)
        if labels is not None:
            loss = F.cross_entropy(logits[:, :-1], labels[:, 1:])
            return loss, logits
        return logits

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def generate(self, input_ids, **kwargs):
        """Autoregressive decoding by recompute (see
        paddle_tpu_torch.generation)."""
        from ..generation import generate
        return generate(self, input_ids, **kwargs)


def gpt_tiny(*, device=None, **kw):
    """Small config for tests and dry runs."""
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=256)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device)


def gpt3_1p3b(*, device=None, **kw):
    """GPT-3 1.3B: hidden 2048, 16 heads of 128, FFN 8192, 24 layers, vocab
    50304, 2048 positions."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
               num_attention_heads=16, max_position_embeddings=2048)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device)

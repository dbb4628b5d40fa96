"""Llama model family. reference: paddle_tpu/models/llama.py.

The modules keep the reference's parameter names and Paddle's (in, out)
Linear layout, so `state_dict()` keys and shapes equal the JAX model's
(e.g. `llama.layers.0.self_attn.q_proj.weight`, (hidden, heads*head_dim)).
Every module takes `device=`; without it the default device ("cuda") is
used. `LlamaConfig.dtype` is the parameters' dtype.

Attention goes through `scaled_dot_product_attention`, which takes the
flash kernels on CUDA (K1 forward, K3/K4 backward) where
ops/attention_router picks them for the shape.
"""

from __future__ import annotations

from ..incubate.nn.functional import fused_rotary_position_embedding, swiglu
from ..nn import Embedding, LayerList, Linear, RMSNorm
from ..nn import functional as F
from ..nn.layer.layers import Layer

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_7b", "llama_13b"]


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 dtype="float32", use_flash_attention=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.dtype = dtype
        # stored and read by nothing, as in the reference: the attention
        # backend is the router's (ops/attention_router)
        self.use_flash_attention = use_flash_attention


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        kw = dict(bias_attr=False, dtype=config.dtype, device=device)
        self.q_proj = Linear(h, self.num_heads * self.head_dim, **kw)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, **kw)

    def forward(self, hidden, position_ids=None, attn_mask=None):
        b, s = hidden.shape[0], hidden.shape[1]
        q = self.q_proj(hidden).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, position_ids=position_ids,
            rotary_emb_base=self.config.rope_theta)
        # kv heads stay unexpanded (GQA); always causal, a user mask is
        # added to the causal structure
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(bias_attr=False, dtype=config.dtype, device=device)
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        kw = dict(dtype=config.dtype, device=device)
        self.self_attn = LlamaAttention(config, device=device)
        self.mlp = LlamaMLP(config, device=device)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)

    def forward(self, hidden, position_ids=None, attn_mask=None):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden),
                                         position_ids, attn_mask)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      dtype=config.dtype, device=device)
        self.layers = LayerList(
            [LlamaDecoderLayer(config, device=device)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            dtype=config.dtype, device=device)

    def forward(self, input_ids, position_ids=None, attn_mask=None):
        hidden = self.embed_tokens(input_ids)
        for layer in self.layers:
            hidden = layer(hidden, position_ids, attn_mask)
        return self.norm(hidden)


class LlamaForCausalLM(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        self.llama = LlamaModel(config, device=device)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False, dtype=config.dtype,
                                  device=device)

    def forward(self, input_ids, position_ids=None, labels=None):
        """Logits (batch, seq, vocab); with `labels`, (loss, logits), the
        loss being the next-token cross-entropy: logits[:, t] predict
        labels[:, t + 1]."""
        hidden = self.llama(input_ids, position_ids)
        if self.lm_head is not None:
            logits = self.lm_head(hidden)
        else:
            logits = F.linear(hidden, self.llama.embed_tokens.weight.T)
        if labels is not None:
            loss = F.cross_entropy(logits[:, :-1], labels[:, 1:],
                                   reduction="mean")
            return loss, logits
        return logits

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def generate(self, input_ids, **kwargs):
        """KV-cache decoding (see paddle_tpu_torch.generation)."""
        from ..generation import generate
        return generate(self, input_ids, **kwargs)


def llama_tiny(*, device=None, **kw):
    """Small config for tests and dry runs."""
    cfg = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=256)
    cfg.update(kw)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device)


def llama_7b(*, device=None, **kw):
    """Llama-2-7B: hidden 4096, 32 heads of 128, FFN 11008, 32 layers."""
    cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=32, num_attention_heads=32)
    cfg.update(kw)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device)


def llama_13b(*, device=None, **kw):
    cfg = dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
               num_hidden_layers=40, num_attention_heads=40)
    cfg.update(kw)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device)

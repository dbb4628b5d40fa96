"""BERT model family. reference: paddle_tpu/models/bert.py.

Post-LN encoder with MLM and NSP pretraining heads. Module and parameter
names and Paddle's (in, out) Linear layout follow the reference, so
`state_dict()` keys and shapes equal the JAX model's. Every module takes
`device=`; `BertConfig.dtype` is the parameters' dtype. Attention goes
through `scaled_dot_product_attention` without a mask and without the
causal flag (unless the caller passes an attention mask), so on CUDA the
router may send it to the flash kernels: K1 forward, K3/K4 backward.
"""

from __future__ import annotations

import torch

from ..nn import Dropout, Embedding, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ._init import transformer_init_attr
from ..nn.layer.layers import Layer

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_tiny", "bert_base"]


def _init_attr(config):
    # BERT init: truncated normal(0, initializer_range) on every weight
    # matrix; the Embedding N(0, 1) default blows up the tied MLM logits
    return transformer_init_attr(config.initializer_range, truncated=True)


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, dropout=0.1, initializer_range=0.02,
                 *, dtype="float32"):
        self.initializer_range = initializer_range
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps
        self.dropout = dropout
        self.dtype = dtype


def _kw(config, device):
    return dict(dtype=config.dtype, device=device)


class BertEmbeddings(Layer):
    def __init__(self, config, *, device=None):
        super().__init__()
        kw = dict(weight_attr=_init_attr(config), **_kw(config, device))
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps,
                                    **_kw(config, device))
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertLayer(Layer):
    def __init__(self, config, *, device=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        kw = dict(weight_attr=_init_attr(config), **_kw(config, device))
        eps = config.layer_norm_eps
        self.q = Linear(h, h, **kw)
        self.k = Linear(h, h, **kw)
        self.v = Linear(h, h, **kw)
        self.attn_out = Linear(h, h, **kw)
        self.attn_norm = LayerNorm(h, eps, **_kw(config, device))
        self.ffn1 = Linear(h, config.intermediate_size, **kw)
        self.ffn2 = Linear(config.intermediate_size, h, **kw)
        self.ffn_norm = LayerNorm(h, eps, **_kw(config, device))
        self.dropout = Dropout(config.dropout)

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.q(x).reshape(shape)
        k = self.k(x).reshape(shape)
        v = self.v(x).reshape(shape)
        attn = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                              training=self.training)
        attn = self.attn_out(attn.reshape(b, s, -1))
        x = self.attn_norm(x + self.dropout(attn))
        h = self.ffn2(F.gelu(self.ffn1(x)))
        return self.ffn_norm(x + self.dropout(h))


class BertModel(Layer):
    def __init__(self, config: BertConfig, *, device=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device=device)
        self.encoder = LayerList([BertLayer(config, device=device)
                                  for _ in range(config.num_hidden_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             weight_attr=_init_attr(config),
                             **_kw(config, device))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """(sequence output, pooled first token). A 2-D (b, s) 1/0
        `attention_mask` becomes the additive (b, 1, 1, s) bias 0 / -1e30
        (reference :112-117); another shape passes as it is."""
        if attention_mask is not None and attention_mask.dim() == 2:
            attention_mask = torch.where(attention_mask[:, None, None, :] > 0,
                                         0.0, -1e30)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(Layer):
    def __init__(self, config: BertConfig, *, device=None):
        super().__init__()
        self.bert = BertModel(config, device=device)
        h = config.hidden_size
        wa = _init_attr(config)
        self.mlm_transform = Linear(h, h, weight_attr=wa,
                                    **_kw(config, device))
        self.mlm_norm = LayerNorm(h, config.layer_norm_eps,
                                  **_kw(config, device))
        self.nsp_head = Linear(h, 2, weight_attr=wa, **_kw(config, device))
        self.config = config

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        """(mlm_logits, nsp_logits); with `masked_lm_labels` (-100 where not
        masked), (loss, mlm_logits), the loss being the MLM cross-entropy
        plus, with `next_sentence_labels`, the NSP one. The MLM head is tied
        to the word embeddings."""
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = F.linear(h, self.bert.embeddings.word_embeddings.weight.T)
        nsp_logits = self.nsp_head(pooled)
        if masked_lm_labels is not None:
            loss = F.cross_entropy(mlm_logits, masked_lm_labels,
                                   ignore_index=-100)
            if next_sentence_labels is not None:
                loss = loss + F.cross_entropy(nsp_logits,
                                              next_sentence_labels)
            return loss, mlm_logits
        return mlm_logits, nsp_logits


class BertForSequenceClassification(Layer):
    def __init__(self, config: BertConfig, num_classes=2, *, device=None):
        super().__init__()
        self.bert = BertModel(config, device=device)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 weight_attr=_init_attr(config),
                                 **_kw(config, device))
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


def bert_tiny(*, device=None, **kw):
    """Small config for tests and dry runs."""
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=256,
               max_position_embeddings=128)
    cfg.update(kw)
    return BertForPretraining(BertConfig(**cfg), device=device)


def bert_base(*, device=None, **kw):
    """BERT-base: hidden 768, 12 heads of 64, FFN 3072, 12 layers, vocab
    30522."""
    return BertForPretraining(BertConfig(**kw), device=device)

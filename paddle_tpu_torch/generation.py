"""Autoregressive generation with a dense KV cache.

reference: paddle_tpu/generation.py:39-425 (`GenerationConfig`, the llama
layer math, `_sample`, `generate`).

The JAX version is one jit: prefill as a `lax.scan` over the stacked layer
weights, then a `lax.scan` of decode steps. Here both are eager Python
loops over the model's own per-layer parameters: stacking the 32 layers'
weights per call, as the JAX version does, would make a second copy of the
weights (13.5 GB at 7B in bf16). Prefill attention is causal flash
attention (the hand-written kernel K1) where ops/attention_router picks it
for the shape on a CUDA device (`_prefill_flash_routed`, reference :91-102),
and dense torch math otherwise, always on the CPU (reference :125-133);
decode attention is dense torch math over the cache, as in the reference.

Sampling draws from a `torch.Generator`: seeded from `seed` when given,
else the device's generator of `framework.random`. The draws are torch's
and do not reproduce the JAX package's bits; greedy output does not draw.
"""

from __future__ import annotations

import torch

from .framework.random import get_generator
from .ops.flash_attention import NEG_INF, flash_attention_bshd, kernel_takes

__all__ = ["generate", "GenerationConfig"]


class GenerationConfig:
    """reference: the generation knobs of top_p_sampling + sampling loops."""

    def __init__(self, max_new_tokens=32, do_sample=False, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None):
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id


# The layer math below mirrors models/llama.py. It is written again because
# the cache-threaded decode step needs each layer's K/V, which the module
# forward does not return (the reference does the same, generation.py:52-59).
# tests/test_torch_generation.py holds greedy output to the JAX package's
# token for token.


def _rms(x, w, eps):
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * w


def _rope(x, pos, theta):
    """neox-style rope at absolute positions `pos` (b, s); x (b, s, heads,
    head_dim)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = pos[..., None].float() * inv                 # (b, s, d/2)
    emb = torch.cat([freqs, freqs], dim=-1)              # (b, s, d)
    s = emb.sin()[..., None, :].to(x.dtype)              # add head axis
    c = emb.cos()[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return x * c + torch.cat([-x2, x1], dim=-1) * s


def _gqa(a, rep):
    """(b, s, kvh, d) -> (b, s, kvh * rep, d), each kv head repeated over
    its query heads."""
    return a if rep == 1 else a.repeat_interleave(rep, dim=2)


def _mlp(lp, h, eps):
    x = _rms(h, lp["post_attention_layernorm.weight"], eps)
    gate = x @ lp["mlp.gate_proj.weight"]
    up = x @ lp["mlp.up_proj.weight"]
    return h + (torch.nn.functional.silu(gate) * up) @ lp["mlp.down_proj.weight"]


def _prefill_flash_routed(bh, s, d, dtype, device):
    """Prefill attention backend: the router's forward choice for this
    shape (the same ledger as the training path) on a CUDA device, where
    the kernels take the dtype and head dim; dense (False) otherwise."""
    if device.type != "cuda" or not kernel_takes(dtype, d):
        return False
    from .ops.attention_router import route
    return route(bh, s, s, d, dtype, True, platform="cuda").fwd == "pallas"


def _llama_layer_prefill(lp, h, pos, cfg):
    """Full-sequence layer forward; returns (h_out, (k, v)) with k/v rotated
    and unexpanded (kv heads)."""
    eps, theta = cfg["eps"], cfg["theta"]
    nh, nkv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    b, s, _ = h.shape
    x = _rms(h, lp["input_layernorm.weight"], eps)
    q = (x @ lp["self_attn.q_proj.weight"]).reshape(b, s, nh, hd)
    k = (x @ lp["self_attn.k_proj.weight"]).reshape(b, s, nkv, hd)
    v = (x @ lp["self_attn.v_proj.weight"]).reshape(b, s, nkv, hd)
    q = _rope(q, pos, theta)
    k = _rope(k, pos, theta)
    if _prefill_flash_routed(b * nh, s, hd, h.dtype, h.device):
        # GQA-native (kv stays unexpanded), causal: every caller passes
        # pos = arange rows, so the kernel's causal structure is the
        # position mask below
        attn = flash_attention_bshd(q, k, v, causal=True)
    else:
        kx, vx = _gqa(k, nh // nkv), _gqa(v, nh // nkv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) / (
            hd ** 0.5)
        causal = pos[:, :, None] >= pos[:, None, :]       # (b, s, s)
        scores = scores.masked_fill(~causal[:, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(vx.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, vx)
    h = h + attn.reshape(b, s, nh * hd) @ lp["self_attn.o_proj.weight"]
    return _mlp(lp, h, eps), (k, v)


def _llama_layer_decode(lp, h, k_cache, v_cache, t, cfg):
    """One-token layer forward; h (b, 1, H). Writes this token's rotated K/V
    into the caches (b, T, kvh, hd) at position t, in place, and attends
    over positions <= t."""
    eps, theta = cfg["eps"], cfg["theta"]
    nh, nkv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    b = h.shape[0]
    x = _rms(h, lp["input_layernorm.weight"], eps)
    q = (x @ lp["self_attn.q_proj.weight"]).reshape(b, 1, nh, hd)
    k = (x @ lp["self_attn.k_proj.weight"]).reshape(b, 1, nkv, hd)
    v = (x @ lp["self_attn.v_proj.weight"]).reshape(b, 1, nkv, hd)
    pos = torch.full((b, 1), t, dtype=torch.long, device=h.device)
    q = _rope(q, pos, theta)
    k_cache[:, t] = _rope(k, pos, theta)[:, 0]
    v_cache[:, t] = v[:, 0]
    # positions > t are masked in the reference (exp(-1e30 - m) = 0); they
    # are left out here, so the unfilled part of the cache is never read
    kx = _gqa(k_cache[:, :t + 1], nh // nkv)
    vx = _gqa(v_cache[:, :t + 1], nh // nkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) / (
        hd ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(vx.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, vx).reshape(b, 1, nh * hd)
    h = h + attn @ lp["self_attn.o_proj.weight"]
    return _mlp(lp, h, eps)


def _sample(logits, generator, gc: GenerationConfig):
    """Next token from f32 logits (b, vocab): argmax when greedy, else
    temperature, then top-k, then top-p filtering and a categorical draw."""
    if not gc.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(gc.temperature, 1e-6)
    if gc.top_k and gc.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -gc.top_k][..., None]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if gc.top_p < 1.0:   # top_p == 1 skips the full-vocab sort entirely
        probs = torch.softmax(logits, dim=-1)
        sorted_p, order = torch.sort(probs, dim=-1, descending=True)
        keep_sorted = (torch.cumsum(sorted_p, dim=-1) - sorted_p) < gc.top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=None):
    """Generate continuations with a KV cache. Returns (batch,
    prompt + max_new_tokens) int64 ids on the model's device; after an
    `eos_token_id` every later token is `eos_token_id`."""
    from .models.llama import LlamaForCausalLM
    if not isinstance(model, LlamaForCausalLM):
        raise TypeError("generate supports LlamaForCausalLM")
    gc = GenerationConfig(max_new_tokens, do_sample, temperature, top_k,
                          top_p, eos_token_id)
    embed_w = model.llama.embed_tokens.weight
    device = embed_w.device
    ids = torch.as_tensor(input_ids, device=device).long()
    if max_new_tokens <= 0:
        return ids
    if do_sample:
        if seed is not None:
            generator = torch.Generator(device=device)
            generator.manual_seed(int(seed))
        else:
            generator = get_generator(device)
    else:
        generator = None
    c = model.config
    cfg = dict(eps=c.rms_norm_eps, theta=c.rope_theta,
               heads=c.num_attention_heads, kv_heads=c.num_key_value_heads,
               head_dim=c.hidden_size // c.num_attention_heads)
    norm_w = model.llama.norm.weight
    head_w = embed_w.T if model.lm_head is None else model.lm_head.weight
    layers = [dict(layer.named_parameters()) for layer in model.llama.layers]

    def logits_of(h_last):
        return (_rms(h_last, norm_w, cfg["eps"]) @ head_w).float()

    b, s = ids.shape
    # the KV cache is preallocated for the whole run, (L, b, prompt + new,
    # kv heads, head dim), and filled in place: prefill writes [:s], each
    # decode step writes one position
    cache_shape = (len(layers), b, s + max_new_tokens, cfg["kv_heads"],
                   cfg["head_dim"])
    k_cache = torch.empty(cache_shape, dtype=embed_w.dtype, device=device)
    v_cache = torch.empty(cache_shape, dtype=embed_w.dtype, device=device)

    pos = torch.arange(s, device=device)[None].expand(b, s)
    h = embed_w[ids]
    for i, lp in enumerate(layers):
        h, (k, v) = _llama_layer_prefill(lp, h, pos, cfg)
        k_cache[i, :, :s] = k
        v_cache[i, :, :s] = v
    tok = _sample(logits_of(h[:, -1]), generator, gc)

    out = [tok]
    done = torch.zeros(b, dtype=torch.bool, device=device)
    for step in range(max_new_tokens - 1):
        t = s + step
        hh = embed_w[tok[:, None]]                       # (b, 1, H)
        for i, lp in enumerate(layers):
            hh = _llama_layer_decode(lp, hh, k_cache[i], v_cache[i], t, cfg)
        nxt = _sample(logits_of(hh[:, -1]), generator, gc)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
            nxt = torch.where(done, eos_token_id, nxt)
        out.append(nxt)
        tok = nxt
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

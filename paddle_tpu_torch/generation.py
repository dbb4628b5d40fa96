"""Autoregressive generation: Llama with a dense KV cache, every other
causal LM by recompute.

reference: paddle_tpu/generation.py:39-536 (`GenerationConfig`, the llama
layer math, `_sample`, `_generic_generate`, `generate`,
`WeightOnlyGenerator`).

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
from .nn.quant.format import div
from .observability import span as _span
from .observability.catalog import metric as _metric
from .observability.tracing import get_tracer as _tracer
from .observability.tracing import new_trace_id as _new_trace_id
from .ops.flash_attention import NEG_INF, flash_attention_bshd, kernel_takes

__all__ = ["generate", "GenerationConfig", "WeightOnlyGenerator"]


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


def _llama_layer_prefill_chunk(lp, h, kc, vc, table_row, start, cfg,
                               fmt=None, kc_scale=None, vc_scale=None,
                               lora=None):
    """One layer forward over a prompt CHUNK against the paged pool, the
    serving engine's chunked prefill (reference :142-208): rotate the
    chunk's Q/K at absolute positions, scatter the chunk's K/V into the
    pool (in place), then attend over every cached position <= each
    query's (earlier chunks, and causal within the chunk).

    h: (1, C, H) chunk hidden states; kc/vc: ONE layer's (num_blocks,
    block_size, KVH, D) pool; table_row: (max_blocks,) block table of the
    owning sequence; start: absolute position of the chunk's first token.
    Returns (h_out, (kc, vc)), or (h_out, (kc, vc, kc_scale, vc_scale))
    with a quantized `fmt` and its scale pools. `lora`: an optional
    (A_q [H, r], B_q [r, Dq], A_v [H, r], B_v [r, Dv]) tuple of this
    layer's adapter factors; the q and v projections gain x @ A @ B deltas
    (reference :177-184)."""
    from .ops.paged_attention import (kv_write_chunk,
                                      paged_attention_prefill_chunk)
    eps, theta = cfg["eps"], cfg["theta"]
    nh, nkv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    b, c, _ = h.shape                      # b == 1: one admission at a time
    pos = start + torch.arange(c, device=h.device)[None]     # (1, C)
    x = _rms(h, lp["input_layernorm.weight"], eps)
    q = x @ lp["self_attn.q_proj.weight"]
    v = x @ lp["self_attn.v_proj.weight"]
    if lora is not None:
        a_q, b_q, a_v, b_v = (w.to(x.dtype) for w in lora)
        q = q + (x @ a_q) @ b_q
        v = v + (x @ a_v) @ b_v
    q = q.reshape(b, c, nh, hd)
    k = (x @ lp["self_attn.k_proj.weight"]).reshape(b, c, nkv, hd)
    v = v.reshape(b, c, nkv, hd)
    q = _rope(q, pos, theta)
    k = _rope(k, pos, theta)
    quant = fmt is not None and fmt.quantized
    kc, vc, kc_scale, vc_scale = kv_write_chunk(
        fmt if quant else None, kc, vc, kc_scale, vc_scale, k[0], v[0],
        table_row, start)
    attn = paged_attention_prefill_chunk(q[0], kc, vc, table_row, start,
                                         scale=1.0 / (hd ** 0.5),
                                         fmt=fmt if quant else None,
                                         k_scale_cache=kc_scale,
                                         v_scale_cache=vc_scale)
    h = h + attn.reshape(b, c, nh * hd) @ lp["self_attn.o_proj.weight"]
    h = _mlp(lp, h, eps)
    if quant:
        return h, (kc, vc, kc_scale, vc_scale)
    return h, (kc, vc)


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


def _generic_generate(model, ids, gc, generator):
    """The recompute path for a causal LM without a cache path (reference
    :332-348): the whole prefix runs through the model again for each new
    token. After an EOS every later token is EOS."""
    done = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
    vocab = getattr(getattr(model, "config", None), "vocab_size", None)
    for _ in range(gc.max_new_tokens):
        with _span("generation.decode_step"):
            out = model(ids)
        logits = out[0] if isinstance(out, tuple) else out
        if vocab is not None and logits.shape[-1] != vocab:
            raise TypeError(
                f"generate needs a causal LM that returns (batch, seq, "
                f"vocab) logits; {type(model).__name__} returned "
                f"{tuple(logits.shape)} for vocab {vocab}")
        nxt = _sample(logits[:, -1].float(), generator, gc)
        if gc.eos_token_id is not None:
            nxt = torch.where(done, gc.eos_token_id, nxt)
            done = done | (nxt == gc.eos_token_id)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids


def _generator(device, do_sample, seed):
    """None when greedy; else a generator seeded from `seed`, or the
    device's generator of `framework.random`."""
    if not do_sample:
        return None
    if seed is None:
        return get_generator(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=None):
    """Generate continuations. Returns (batch, prompt + max_new_tokens)
    int64 ids on the model's device; after an `eos_token_id` every later
    token is `eos_token_id`; with max_new_tokens <= 0, the prompt.

    LlamaForCausalLM takes the KV-cache path; every other causal LM (GPT)
    the recompute path, one whole forward per new token (reference
    :351-425). Greedy decoding draws nothing; sampling draws from a
    generator seeded from `seed`, else from the device's generator of
    `framework.random`.

    Observability as the reference's (:378-420): each call counts on
    `generation_requests_total{path=...}`, "llama_compiled" (the
    reference's name for its Llama path) or "generic_recompute", and runs
    under a `generation.generate` span with its own trace id. The Llama
    path's device work runs under a `generation.prefill_decode` span
    (synchronized only while tracing is on), the recompute path's steps
    under `generation.decode_step` spans. The reference's
    `generation.build` span times its jit build, which the eager port does
    not have."""
    from .models.llama import LlamaForCausalLM
    gc = GenerationConfig(max_new_tokens, do_sample, temperature, top_k,
                          top_p, eos_token_id)
    device = next(iter(model.parameters())).device
    ids = torch.as_tensor(input_ids, device=device).long()
    if max_new_tokens <= 0:
        return ids
    generator = _generator(device, do_sample, seed)
    tid = _new_trace_id("gen-") if _tracer().enabled else None
    path = ("llama_compiled" if isinstance(model, LlamaForCausalLM)
            else "generic_recompute")
    _metric("generation_requests_total", path=path).inc()
    with _span("generation.generate", path=path,
               batch=int(ids.shape[0]), prompt=int(ids.shape[1]),
               new_tokens=int(max_new_tokens), trace_id=tid):
        if path == "generic_recompute":
            return _generic_generate(model, ids, gc, generator)
        with _span("generation.prefill_decode"):
            out = _generate_llama(model, ids, gc, generator)
            if _tracer().enabled and device.type == "cuda":
                torch.cuda.synchronize(device)
    return out


def _llama_cfg(c):
    return dict(eps=c.rms_norm_eps, theta=c.rope_theta,
                heads=c.num_attention_heads, kv_heads=c.num_key_value_heads,
                head_dim=c.hidden_size // c.num_attention_heads)


def _generate_llama(model, ids, gc, generator):
    """generate's Llama body over the model's own weights."""
    head_w = None if model.lm_head is None else model.lm_head.weight
    layers = [dict(layer.named_parameters()) for layer in model.llama.layers]
    return _generate_llama_weights(
        layers, model.llama.embed_tokens.weight, model.llama.norm.weight,
        head_w, _llama_cfg(model.config), ids, gc, generator)


def _generate_llama_weights(layers, embed_w, norm_w, head_w, cfg, ids, gc,
                            generator):
    """Prefill, then the decode loop, over explicit weights: `layers`, one
    dict of parameters a layer, keyed as a LlamaDecoderLayer's; the
    embedding, the final norm, and the (hidden, vocab) head, None when tied
    to the embedding."""
    device = embed_w.device
    max_new_tokens, eos_token_id = gc.max_new_tokens, gc.eos_token_id
    if head_w is None:
        head_w = embed_w.T

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


def _quantize_int8(w):
    """Per-output-channel absmax int8 of a (..., in, out) weight: the scale
    (..., 1, out) is max |w| over `in` / 127, floored at 1e-8; the levels
    are w / scale in float32, rounded half to even, clipped to +-127."""
    w32 = w.float()
    scale = div(w32.abs().amax(dim=-2, keepdim=True), 127.0).clamp(min=1e-8)
    return torch.round(w32 / scale).clamp(-127, 127).to(torch.int8), scale


class WeightOnlyGenerator:
    """Weight-only int8 serving of a LlamaForCausalLM. reference:
    generation.py:428-536.

    The model's weights are snapshotted once: each layer's matmul weights
    and an untied head as int8 with float32 scales per output channel
    (`_quantize_int8`); the norms and the embedding stay in the compute
    dtype. Each `generate` call dequantizes them in float32, then casts to
    the compute dtype, once, ahead of prefill and decode, as the reference
    does ahead of its scans; the dequantized copy lives for that call only,
    so between calls the card holds the int8 snapshot. The prefill goes
    through `_prefill_flash_routed`, and so through K1 where the router
    picks it, as `generate` does."""

    def __init__(self, model, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 algo="weight_only_int8", share_weights_from=None):
        from .models.llama import LlamaForCausalLM
        if not isinstance(model, LlamaForCausalLM):
            raise TypeError(
                "WeightOnlyGenerator supports LlamaForCausalLM; for other "
                "models use generate() with externally quantized weights")
        if algo != "weight_only_int8":
            raise NotImplementedError(
                f"algo={algo!r}: only weight_only_int8 is supported")
        self._gc = GenerationConfig(max_new_tokens, do_sample, temperature,
                                    top_k, top_p, eos_token_id)
        self._cfg = _llama_cfg(model.config)
        if share_weights_from is not None:
            # the same snapshot at another generation length: no requantize
            src = share_weights_from
            self._q, self._s, self._fp = src._q, src._s, src._fp
            self._embed, self._norm = src._embed, src._norm
            self._qh, self._sh = src._qh, src._sh
            self._tied = src._tied
            return
        with torch.no_grad():
            self._q, self._s, self._fp = [], [], []
            for layer in model.llama.layers:
                q, sc, fp = {}, {}, {}
                for k, v in layer.named_parameters():
                    if v.dim() >= 2:             # (in, out) matmul weights
                        q[k], sc[k] = _quantize_int8(v)
                    else:                        # norm vectors
                        fp[k] = v.detach().clone()
                self._q.append(q)
                self._s.append(sc)
                self._fp.append(fp)
            self._embed = model.llama.embed_tokens.weight.detach().clone()
            self._norm = model.llama.norm.weight.detach().clone()
            self._tied = model.lm_head is None
            dev = self._embed.device
            if self._tied:
                self._qh = torch.zeros((0, 0), dtype=torch.int8, device=dev)
                self._sh = torch.zeros((0, 0), device=dev)
            else:
                self._qh, self._sh = _quantize_int8(model.lm_head.weight)

    def quantized_bytes(self):
        """Bytes the snapshot holds: int8 levels, float32 scales, and the
        norms and embedding in the compute dtype (the reference's sum)."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        total = sum(nbytes(d.values()) for d in self._q + self._s + self._fp)
        return total + nbytes([self._embed, self._norm, self._qh, self._sh])

    def dequantized_weights(self):
        """(layers, head) as a generate call sees them: each int8 weight
        times its scale in float32, cast to the compute dtype; head None
        when tied."""
        cdt = self._embed.dtype
        layers = []
        for q, sc, fp in zip(self._q, self._s, self._fp):
            lp = dict(fp)
            for k in q:
                lp[k] = (q[k].float() * sc[k]).to(cdt)
            layers.append(lp)
        head = (None if self._tied
                else (self._qh.float() * self._sh).to(cdt))
        return layers, head

    @torch.inference_mode()
    def generate(self, input_ids, seed=None):
        """(batch, prompt + max_new_tokens) int64 ids, as `generate`."""
        device = self._embed.device
        ids = torch.as_tensor(input_ids, device=device).long()
        if self._gc.max_new_tokens <= 0:
            return ids
        generator = _generator(device, self._gc.do_sample, seed)
        layers, head = self.dequantized_weights()
        return _generate_llama_weights(layers, self._embed, self._norm, head,
                                       self._cfg, ids, self._gc, generator)

"""A/B, in one call on one card, of the serving engine's decode attention
in four page layouts.

    python3 -m paddle_tpu_torch.tools.ab_paged_decode

- "einsum": the pages gathered lane-major, [B, L, KVH, D], and both
  products by `torch.einsum`, which copies the pages into [B, KVH, L, D]
  before each (the first port of paged_attention_decode_inner);
- "head-major": the pages gathered from a permuted view of the pool
  straight into [KVH, B, L, D], both products as batched matmuls;
- "block-diagonal [B, L, H]": the lane-major gather with block-diagonal
  queries, the scores [B, L, H], so the softmax runs across strided rows;
- "block-diagonal": what ops/paged_attention.paged_attention_decode_inner
  does, the same with the scores [B, H, L].

Builds llama_7b in bf16 at full width and depth with random weights from
seed(0) and an engine at chip_smoke.py's knobs, puts 8 lanes at position
1,024, captures the greedy K=4 decode program once per layout, and times
each replay (CUDA events, median of 5, the lane state restored before
each) in the order of the list above and then back. The tiles must be
equal. Needs one CUDA device.
"""

from __future__ import annotations

import sys

import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import ContinuousBatchingEngine, serving
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.tools import profile_serving as ps


def _einsum(q, k_cache, v_cache, block_tables, seq_lens, scale=None,
            **_):
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    k, v = pa._gather_pages(k_cache, v_cache, block_tables, None, None,
                            None)
    L = k.shape[1]
    qg = q.reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bhgd,blhd->bhgl", qg, k).float() * scale
    mask = torch.arange(L, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], pa.NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgl,blhd->bhgd", p, v).reshape(B, H, D)


def _head_major(q, k_cache, v_cache, block_tables, seq_lens, scale=None,
                **_):
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    tables = block_tables.long()
    L = tables.shape[1] * k_cache.shape[1]
    k = k_cache.permute(2, 0, 1, 3)[:, tables].reshape(KVH, B, L, D)
    v = v_cache.permute(2, 0, 1, 3)[:, tables].reshape(KVH, B, L, D)
    qg = q.reshape(B, KVH, H // KVH, D).transpose(0, 1)
    s = torch.matmul(qg, k.transpose(-1, -2)).float() * scale
    mask = torch.arange(L, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[None, :, None, :], pa.NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v).transpose(0, 1).reshape(B, H, D)


def _block_diagonal_lhs(q, k_cache, v_cache, block_tables, seq_lens,
                        scale=None, **_):
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    k, v = pa._gather_pages(k_cache, v_cache, block_tables, None, None,
                            None)
    L = k.shape[1]
    k, v = k.reshape(B, L, KVH * D), v.reshape(B, L, KVH * D)
    eye = torch.eye(KVH, dtype=q.dtype, device=q.device)
    q_bd = torch.einsum("bhgd,hj->bhdjg", q.reshape(B, KVH, G, D),
                        eye).reshape(B, KVH * D, H)
    s = torch.bmm(k, q_bd).float() * scale                   # [B, L, H]
    mask = torch.arange(L, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, :, None], pa.NEG_INF)
    p = torch.softmax(s, dim=1).to(v.dtype)
    o = torch.bmm(p.transpose(1, 2), v).reshape(B, KVH, G, KVH, D)
    return o.diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2).reshape(B, H, D)


LAYOUTS = {"einsum": _einsum, "head-major": _head_major,
           "block-diagonal [B, L, H]": _block_diagonal_lhs,
           "block-diagonal": pa.paged_attention_decode_inner}


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_paged_decode: needs a CUDA device")
    pt.seed(0)
    model = pt.models.llama_7b(dtype="bfloat16", device="cuda").eval()
    eng = ContinuousBatchingEngine(model, **ps.ENGINE)
    reset = ps.lane_state(eng, model.config.vocab_size)
    graphs, tiles = {}, {}
    try:
        with torch.no_grad():
            for name, fn in LAYOUTS.items():
                serving.paged_attention_decode_inner = fn
                reset()
                graphs[name] = eng._capture(False, ps.ENGINE["decode_steps"])
                reset()
                graphs[name].graph.replay()
                tiles[name] = graphs[name].tile.clone()
    finally:
        serving.paged_attention_decode_inner = LAYOUTS["block-diagonal"]
    order = list(LAYOUTS) + list(LAYOUTS)[::-1]
    for name in order:
        ms = ps.median_ms(graphs[name].graph.replay, reset)
        print(f"{name}: K={ps.ENGINE['decode_steps']} tile over "
              f"{eng.max_batch} lanes {ms:.3f} ms")
    same = all(torch.equal(t, tiles["einsum"]) for t in tiles.values())
    print("same tiles:", same)
    print("device:", torch.cuda.get_device_name(0))
    if not same:
        sys.exit("ab_paged_decode: the layouts give different tiles")


if __name__ == "__main__":
    main()

"""Paged KV-cache attention (block attention) for the serving engine.

reference: paddle_tpu/ops/paged_attention.py — `KVBlockFormat` (:43), the
writes and the rollback (:128-293), decode, verify and prefill-chunk
attention (:295-428) and `BlockKVCacheManager` (:430).

The cache is a pool of fixed-size blocks, [num_blocks, block_size,
num_kv_heads, head_dim]; each sequence owns a list of block ids (its row of
`block_tables`), so memory is allocated in block_size granules with no
per-sequence reservation. The reference's versions are plain `jnp`, and so
these are plain torch: its per-lane `vmap`s become batched index
arithmetic, with no Python loop over lanes and no host synchronisation, so
the serving engine can capture them in a CUDA graph.

Two departures from the reference's functional style:
- Writes land IN PLACE in the cache tensors (`index_put_`), which are also
  returned, so the reference's `k_cache, v_cache = write(...)` call shape
  still reads right. A copy of a 7B pool per token would move gigabytes.
- A block index past a table row is clamped to the row's last entry
  (which the engine pads with its scratch block) wherever it is looked
  up; the reference's `take_along_axis` leaves that case to XLA's
  out-of-bounds rule, and a CUDA gather would fault.

Quantized block formats store int8 or fp8 payloads with one bfloat16 scale
per (token, head) in a parallel [num_blocks, block_size, num_kv_heads]
pool; attention gathers a block and its scales by the same table lookup
and dequantizes at the read.
"""

from __future__ import annotations

import math

import torch

from ..framework.dtypes import NAME2DTYPE
from ..nn.quant.format import fp8_limits

__all__ = ["paged_attention_decode", "paged_attention_decode_inner",
           "paged_attention_prefill_chunk", "paged_attention_verify",
           "write_to_cache", "write_chunk_to_cache", "KVBlockFormat",
           "kv_write_token", "kv_write_chunk", "kv_write_tokens",
           "kv_rollback_tokens", "BlockKVCacheManager"]

NEG_INF = -1e30


class KVBlockFormat:
    """Storage format of the paged KV pool.

    name:
      "native"/"bf16" -> passthrough: blocks hold `native_dtype`, no scales.
      "int8"          -> symmetric absmax int8 per (token, head):
                         q = round(x / s), s = absmax / 127.
      "fp8_e4m3"/"fp8_e5m2" -> torch float8 storage, absmax scaled onto
                         the fp8 grid: q = x / s * fmax rounded through the
                         fp8 dtype, x' = q / fmax * s.

    Scales are bfloat16, one per (token, head). Encode uses the rounded
    stored scale, so decode is its exact inverse modulo the payload grid.
    """

    NAMES = ("native", "bf16", "int8", "fp8_e4m3", "fp8_e5m2")

    def __init__(self, name="native", native_dtype=torch.bfloat16):
        if name not in self.NAMES:
            raise ValueError(
                f"unknown kv cache format {name!r}; one of {self.NAMES}")
        self.name = name
        self.native_dtype = native_dtype
        self.scale_dtype = torch.bfloat16
        self.quantized = name not in ("native", "bf16")
        if name == "int8":
            self.store_dtype = torch.int8
            self._qmax = 127.0
            self._fmax = None
        elif self.quantized:
            fmax, dtype_name = fp8_limits(name.split("_", 1)[1])
            self.store_dtype = NAME2DTYPE[dtype_name]
            self._qmax = None
            self._fmax = fmax
        else:
            self.store_dtype = native_dtype
            self._qmax = self._fmax = None

    def encode(self, x):
        """x [..., D] native -> (payload [..., D] store_dtype, scale [...]
        scale_dtype). Passthrough formats return (x, None)."""
        if not self.quantized:
            return x, None
        x32 = x.float()
        amax = x32.abs().amax(dim=-1)
        if self._qmax is not None:                       # int8
            scale = (amax / self._qmax).to(self.scale_dtype)
            safe = torch.where(scale > 0, scale, 1.0).float()
            q = torch.clamp(torch.round(x32 / safe[..., None]),
                            -self._qmax, self._qmax).to(self.store_dtype)
        else:                                            # fp8
            scale = amax.to(self.scale_dtype)
            safe = torch.where(scale > 0, scale, 1.0).float()
            q = torch.clamp(x32 * self._fmax / safe[..., None],
                            -self._fmax, self._fmax).to(self.store_dtype)
        return q, scale

    def decode(self, q, scale):
        """Inverse of encode, in the native compute dtype."""
        if not self.quantized:
            return q
        q32 = q.float()
        s32 = scale.float()[..., None]
        if self._qmax is not None:
            return (q32 * s32).to(self.native_dtype)
        return (q32 / self._fmax * s32).to(self.native_dtype)

    def bytes_per_token(self, kv_heads, head_dim):
        """Device bytes one cached token costs in ONE of the k/v pools
        (payload + its scales); double for k and v."""
        item = torch.empty((), dtype=self.store_dtype).element_size()
        payload = kv_heads * head_dim * item
        if not self.quantized:
            return payload
        return payload + kv_heads * torch.empty(
            (), dtype=self.scale_dtype).element_size()


def _lookup(table, idx):
    """table[..., idx] along the last axis with idx clamped into the row,
    as int64 block ids."""
    return torch.gather(table.long(), -1,
                        idx.long().clamp(0, table.shape[-1] - 1))


def write_to_cache(k_cache, v_cache, k_new, v_new, block_tables, write_pos,
                   active=None, scratch_block=None):
    """Scatter new K/V (one token per sequence) into the paged cache.

    k_new/v_new: [B, KVH, D]; block_tables: [B, max_blocks] int; write_pos:
    [B] absolute position of the new token per sequence. When `active`
    ([B] bool) is given, inactive rows write to `scratch_block` instead of
    their table entry. Returns (k_cache, v_cache), written in place.
    """
    block_size = k_cache.shape[1]
    block_ids = _lookup(block_tables,
                        (write_pos // block_size)[:, None])[:, 0]
    in_block = (write_pos % block_size).long()
    if active is not None:
        block_ids = torch.where(active, block_ids, scratch_block)
    k_cache[block_ids, in_block] = k_new.to(k_cache.dtype)
    v_cache[block_ids, in_block] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _chunk_slots(table_row, start, count, block_size):
    """(block_ids [C], in_block [C]) of one sequence's C contiguous tokens
    from absolute position `start` (an int or a 0-d tensor)."""
    pos = start + torch.arange(count, device=table_row.device)
    return _lookup(table_row, pos // block_size), (pos % block_size).long()


def write_chunk_to_cache(k_cache, v_cache, k_new, v_new, table_row, start):
    """Scatter a prompt CHUNK's K/V (one sequence, C contiguous tokens)
    into the paged cache, in place.

    k_new/v_new: [C, KVH, D]; table_row: [max_blocks] block table of the
    owning sequence; start: absolute position of the chunk's first token.
    Positions past the row's allocated entries land in whatever the row is
    padded with (the engine pads with its scratch block).
    """
    bids, inb = _chunk_slots(table_row, start, k_new.shape[0],
                             k_cache.shape[1])
    k_cache[bids, inb] = k_new.to(k_cache.dtype)
    v_cache[bids, inb] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _token_slots(block_tables, start_pos, count, block_size,
                 active=None, scratch_block=None):
    """(block_ids [B, C], in_block [B, C]) for `count` contiguous tokens
    per lane starting at start_pos[b]. Dead lanes are routed whole to
    `scratch_block`; positions past a lane's table row clamp to the row's
    last entry."""
    pos = start_pos[:, None] + torch.arange(count,
                                            device=start_pos.device)[None, :]
    block_ids = _lookup(block_tables, pos // block_size)
    if active is not None:
        block_ids = torch.where(active[:, None], block_ids, scratch_block)
    return block_ids, (pos % block_size).long()


def kv_write_tokens(fmt, k_cache, v_cache, k_scale, v_scale,
                    k_new, v_new, block_tables, start_pos,
                    active=None, scratch_block=None):
    """Write C contiguous tokens PER LANE (k_new/v_new [B, C, KVH, D] at
    positions start_pos[b]..start_pos[b]+C-1), saving the pre-write
    contents of every touched slot for rollback.

    Returns (k_cache, v_cache, k_scale, v_scale, saved): `saved` holds the
    old payloads (and old scales when `fmt` quantizes) shaped like the
    writes; kv_rollback_tokens restores rejected positions from it byte for
    byte. Scale caches are [NB, BS, KVH] (None for passthrough formats).
    """
    bids, inb = _token_slots(block_tables, start_pos, k_new.shape[1],
                             k_cache.shape[1], active, scratch_block)
    saved_k = k_cache[bids, inb]                           # [B, C, KVH, D]
    saved_v = v_cache[bids, inb]
    if fmt is not None and fmt.quantized:
        qk, sk = fmt.encode(k_new)
        qv, sv = fmt.encode(v_new)
        saved = (saved_k, saved_v, k_scale[bids, inb], v_scale[bids, inb])
        k_scale[bids, inb] = sk
        v_scale[bids, inb] = sv
    else:
        qk, qv = k_new, v_new
        saved = (saved_k, saved_v)
    k_cache[bids, inb] = qk.to(k_cache.dtype)
    v_cache[bids, inb] = qv.to(v_cache.dtype)
    return k_cache, v_cache, k_scale, v_scale, saved


def kv_rollback_tokens(fmt, k_cache, v_cache, k_scale, v_scale, saved,
                       block_tables, start_pos, keep,
                       active=None, scratch_block=None):
    """Restore the slots a kv_write_tokens call touched wherever keep[b, i]
    is False. Kept slots' restores are redirected to `scratch_block`, so
    the scatter stays dense and branch-free. Returns (k_cache, v_cache,
    k_scale, v_scale)."""
    bids, inb = _token_slots(block_tables, start_pos, keep.shape[1],
                             k_cache.shape[1], active, scratch_block)
    bids = torch.where(keep, scratch_block, bids)
    if fmt is not None and fmt.quantized:
        saved_k, saved_v, saved_ks, saved_vs = saved
        k_scale[bids, inb] = saved_ks
        v_scale[bids, inb] = saved_vs
    else:
        saved_k, saved_v = saved
    k_cache[bids, inb] = saved_k
    v_cache[bids, inb] = saved_v
    return k_cache, v_cache, k_scale, v_scale


def kv_write_token(fmt, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                   block_tables, write_pos, active=None, scratch_block=None):
    """Format-aware single-token write (the non-speculative decode step);
    with a passthrough format it is write_to_cache. Returns (k_cache,
    v_cache, k_scale, v_scale)."""
    if fmt is None or not fmt.quantized:
        k_cache, v_cache = write_to_cache(k_cache, v_cache, k_new, v_new,
                                          block_tables, write_pos,
                                          active, scratch_block)
        return k_cache, v_cache, k_scale, v_scale
    qk, sk = fmt.encode(k_new)
    qv, sv = fmt.encode(v_new)
    k_cache, v_cache = write_to_cache(k_cache, v_cache, qk, qv,
                                      block_tables, write_pos,
                                      active, scratch_block)
    bids, inb = _token_slots(block_tables, write_pos, 1, k_cache.shape[1],
                             active, scratch_block)
    k_scale[bids[:, 0], inb[:, 0]] = sk
    v_scale[bids[:, 0], inb[:, 0]] = sv
    return k_cache, v_cache, k_scale, v_scale


def kv_write_chunk(fmt, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                   table_row, start):
    """Format-aware write_chunk_to_cache (one sequence, C contiguous prompt
    tokens [C, KVH, D]). Returns (k_cache, v_cache, k_scale, v_scale)."""
    if fmt is None or not fmt.quantized:
        k_cache, v_cache = write_chunk_to_cache(k_cache, v_cache, k_new,
                                                v_new, table_row, start)
        return k_cache, v_cache, k_scale, v_scale
    qk, sk = fmt.encode(k_new)
    qv, sv = fmt.encode(v_new)
    k_cache, v_cache = write_chunk_to_cache(k_cache, v_cache, qk, qv,
                                            table_row, start)
    bids, inb = _chunk_slots(table_row, start, k_new.shape[0],
                             k_cache.shape[1])
    k_scale[bids, inb] = sk
    v_scale[bids, inb] = sv
    return k_cache, v_cache, k_scale, v_scale


def _gather_pages(k_cache, v_cache, tables, fmt, k_scale_cache,
                  v_scale_cache):
    """K and V of every position of the rows of `tables` ([..., MB]) ->
    [..., MB * block_size, KVH, D] each, dequantized when `fmt`
    quantizes."""
    tables = tables.long()
    k = k_cache[tables]                                # [..., MB, BS, KVH, D]
    v = v_cache[tables]
    if fmt is not None and fmt.quantized:
        k = fmt.decode(k, k_scale_cache[tables])
        v = fmt.decode(v, v_scale_cache[tables])
    lead = tables.shape[:-1]
    length = tables.shape[-1] * k_cache.shape[1]
    return (k.reshape(*lead, length, *k_cache.shape[2:]),
            v.reshape(*lead, length, *v_cache.shape[2:]))


def paged_attention_decode_inner(q, k_cache, v_cache, block_tables,
                                 seq_lens, scale=None, fmt=None,
                                 k_scale_cache=None, v_scale_cache=None):
    """One decode step over paged caches, for every lane at once.

    q: [B, H, D] (the new token of each sequence); k_cache/v_cache:
    [num_blocks, block_size, KVH, D]; block_tables: [B, max_blocks];
    seq_lens: [B] cached lengths including the new token. GQA: query head
    h reads kv head h // (H // KVH). Scores are taken in the inputs' dtype,
    as the reference's, and the softmax in f32. Returns [B, H, D].

    Each lane's pages are gathered as they lie in the pool, [B, L, KVH,
    D], and both products read them in that layout: the queries go in as
    a block-diagonal [H, KVH * D] matrix per lane (query head h of kv head
    j holds its vector in columns j * D to (j + 1) * D, zeros elsewhere),
    so the scores of every head are one [H, KVH * D] x [KVH * D, L]
    product with the pages read transposed, and P V one [H, L] x
    [L, KVH * D] product whose diagonal blocks are the heads' outputs. The
    zeros add nothing to the sums; the products do KVH times the
    arithmetic of per-head ones, which is small beside reading the pages,
    and no transposed copy of the pages is made. The scores come out
    [B, H, L], so the softmax runs along contiguous rows.
    """
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k, v = _gather_pages(k_cache, v_cache, block_tables, fmt,
                         k_scale_cache, v_scale_cache)   # [B, L, KVH, D]
    L = k.shape[1]
    k = k.reshape(B, L, KVH * D).to(q.dtype)
    v = v.reshape(B, L, KVH * D)
    eye = torch.eye(KVH, dtype=q.dtype, device=q.device)
    q_bd = torch.einsum("bhgd,hj->bhgjd", q.reshape(B, KVH, G, D),
                        eye).reshape(B, H, KVH * D)
    s = torch.bmm(q_bd, k.transpose(1, 2)).float() * scale     # [B, H, L]
    mask = torch.arange(L, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.bmm(p, v).reshape(B, KVH, G, KVH, D)
    o = o.diagonal(dim1=1, dim2=3)                           # [B, G, D, KVH]
    return o.permute(0, 3, 1, 2).reshape(B, H, D).to(q.dtype)


def paged_attention_decode(q, k_cache, v_cache, block_tables, seq_lens,
                           scale=None):
    """One decode step over paged caches (reference :337, a jit of
    paged_attention_decode_inner). q: [B, H, D]; returns [B, H, D]."""
    return paged_attention_decode_inner(q, k_cache, v_cache, block_tables,
                                        seq_lens, scale=scale)


def _causal_over_cache(q, k, v, base, scale):
    """q [..., C, H, D] against k/v [..., L, KVH, D]: query i at absolute
    position base[...] + i attends to every cached position <= its own.
    Scores in f32, P rounded to v's dtype before P V."""
    *lead, C, H, D = q.shape
    L, KVH = k.shape[-3], k.shape[-2]
    qg = q.reshape(*lead, C, KVH, H // KVH, D)
    s = torch.einsum("...chgd,...lhd->...chgl", qg.float(), k.float()) * scale
    pos_q = base[..., None] + torch.arange(C, device=q.device)   # [..., C]
    valid = torch.arange(L, device=q.device) <= pos_q[..., None]  # [..., C, L]
    s = s.masked_fill(~valid[..., :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("...chgl,...lhd->...chgd", p, v)
    return o.reshape(*lead, C, H, D)


def paged_attention_verify(q, k_cache, v_cache, block_tables, base_lens,
                           scale=None, fmt=None, k_scale_cache=None,
                           v_scale_cache=None):
    """Speculative-verify attention: C queries PER LANE, already written to
    the pool, attend causally over each lane's cache.

    q: [B, C, H, D]; base_lens: [B], the lane length BEFORE this step's
    write, so query i sits at position base_lens[b] + i and attends to
    every cached position <= it. Returns [B, C, H, D].
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _gather_pages(k_cache, v_cache, block_tables, fmt,
                         k_scale_cache, v_scale_cache)
    return _causal_over_cache(q, k, v, base_lens, scale)


def paged_attention_prefill_chunk(q, k_cache, v_cache, table_row, start,
                                  scale=None, fmt=None, k_scale_cache=None,
                                  v_scale_cache=None):
    """Chunked-prefill attention for ONE sequence: C chunk queries attend
    over every cached position <= start + qi (earlier chunks already in the
    pool plus the just-written chunk, causal within it).

    q: [C, H, D] (rotated chunk queries); k_cache/v_cache after
    write_chunk_to_cache for this chunk; table_row: [max_blocks]; start:
    absolute position of the chunk's first token. Returns [C, H, D].
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _gather_pages(k_cache, v_cache, table_row, fmt, k_scale_cache,
                         v_scale_cache)
    base = torch.as_tensor(start, device=q.device)
    return _causal_over_cache(q, k, v, base, scale)


class BlockKVCacheManager:
    """Host-side block allocator over one layer's pool, with refcounted
    blocks: sequences can SHARE a prompt prefix (`share`), with
    copy-on-write (`fork_cow`) before a write into a shared block; `free`
    returns a block to the free list only when its last holder lets go."""

    def __init__(self, num_blocks, block_size, num_kv_heads, head_dim,
                 dtype=torch.bfloat16, device=None):
        from ..framework.device import resolve_device
        device = resolve_device(device)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.k_cache = torch.zeros((num_blocks, block_size, num_kv_heads,
                                    head_dim), dtype=dtype, device=device)
        self.v_cache = torch.zeros_like(self.k_cache)
        self._free = list(range(num_blocks - 1, -1, -1))
        self._tables = {}   # seq_id -> [block ids]
        self._lens = {}     # seq_id -> length
        self._ref = {}      # block id -> refcount (absent == free)

    def allocate(self, seq_id, num_tokens):
        """Ensure capacity for `num_tokens` total tokens."""
        need = (num_tokens + self.block_size - 1) // self.block_size
        table = self._tables.setdefault(seq_id, [])
        while len(table) < need:
            if not self._free:
                raise MemoryError("KV cache pool exhausted")
            b = self._free.pop()
            self._ref[b] = 1
            table.append(b)
        self._lens[seq_id] = num_tokens
        return table

    def free(self, seq_id):
        for b in self._tables.pop(seq_id, []):
            n = self._ref.get(b, 1) - 1
            if n <= 0:
                self._ref.pop(b, None)
                self._free.append(b)
            else:
                self._ref[b] = n
        self._lens.pop(seq_id, None)

    def share(self, src_id, dst_id, num_blocks):
        """Start dst's table with src's first `num_blocks` blocks (refcount
        +1 each): a prompt-prefix hit. dst must be fresh."""
        if self._tables.get(dst_id):
            raise ValueError(f"share into non-empty sequence {dst_id!r}")
        src = self._tables[src_id][:num_blocks]
        table = self._tables.setdefault(dst_id, [])
        for b in src:
            self._ref[b] = self._ref.get(b, 0) + 1
            table.append(b)
        self._lens[dst_id] = len(table) * self.block_size
        return table

    def fork_cow(self, seq_id, idx):
        """Give seq_id a private copy of its idx-th block before a write
        lands in it (no-op when already private)."""
        old = self._tables[seq_id][idx]
        if self._ref.get(old, 1) <= 1:
            return old
        if not self._free:
            raise MemoryError("KV cache pool exhausted (COW fork)")
        new = self._free.pop()
        self._ref[new] = 1
        self.k_cache[new] = self.k_cache[old]
        self.v_cache[new] = self.v_cache[old]
        self._tables[seq_id][idx] = new
        n = self._ref.get(old, 1) - 1
        if n <= 0:
            self._ref.pop(old, None)
            self._free.append(old)
        else:
            self._ref[old] = n
        return new

    def prefill(self, seq_id, k, v):
        """Write a whole prompt's K/V ([L, KVH, D]) into fresh blocks."""
        L = k.shape[0]
        table = self.allocate(seq_id, L)
        bs = self.block_size
        pad = len(table) * bs - L
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        ids = torch.as_tensor(table, device=self.k_cache.device)
        self.k_cache[ids] = kp.reshape(len(table), bs, *k.shape[1:]).to(
            self.k_cache.dtype)
        self.v_cache[ids] = vp.reshape(len(table), bs, *v.shape[1:]).to(
            self.v_cache.dtype)
        return table

    def append(self, seq_id, k_new, v_new):
        """Append one token's K/V ([KVH, D]); returns the new length."""
        n = self._lens[seq_id]
        table = self.allocate(seq_id, n + 1)
        dev = self.k_cache.device
        write_to_cache(self.k_cache, self.v_cache, k_new[None], v_new[None],
                       torch.as_tensor([table], device=dev),
                       torch.as_tensor([n], device=dev))
        return n + 1

    def batch_tables(self, seq_ids, pad_to=None):
        """Dense [B, max_blocks] int32 table + [B] int32 lengths for a
        decode batch (unused entries 0)."""
        mb = max(len(self._tables[s]) for s in seq_ids)
        if pad_to:
            mb = max(mb, pad_to)
        tables = torch.zeros((len(seq_ids), mb), dtype=torch.int32)
        lens = torch.zeros((len(seq_ids),), dtype=torch.int32)
        for i, s in enumerate(seq_ids):
            t = self._tables[s]
            tables[i, :len(t)] = torch.as_tensor(t, dtype=torch.int32)
            lens[i] = self._lens[s]
        dev = self.k_cache.device
        return tables.to(dev), lens.to(dev)

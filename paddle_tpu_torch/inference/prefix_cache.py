"""Cross-request prefix cache index: block-granular prompt-prefix
sharing for the paged KV pool (round 18).

Production chat/RAG traffic repeats prompt prefixes (system prompts,
few-shot templates, retrieval contexts). The serving engine keys a
radix-style index by a CHAINED rolling hash over block-aligned token
chunks: chunk i's key is blake2b(key[i-1] || tokens[i*bs:(i+1)*bs]), so
a key identifies the entire prefix up to and including its chunk — two
prompts share a node if and only if they share every token before it.
The chain is seeded with an identity string (model dtype + KV block
format + block size), so an engine whose pool format changes (e.g. the
serve.kv_dequant degradation re-encodes the pool) can never resolve a
stale entry from the old byte layout — the engine clears the index on
any such transition.

Each node owns ONE pool block id. The pool's refcounting pins it: the
index holds a +1 reference, every request that adopts it at admission
holds another, and the block returns to the free list only when the
last reference drops. Blocks in the index are immutable by
construction — only fully-prompt-covered blocks are ever inserted
(decode and speculative-draft writes land at positions >= the prompt
length, i.e. in later blocks), and the one case where a tail prefill
must write inside a shared block (a block-aligned full-prefix match
still re-runs the final prompt position for the first-token logits) is
handled by the pool's copy-on-write fork BEFORE the write.

Hash collisions cannot corrupt streams: every node stores its chunk's
raw tokens and lookup/insert verify them — a mismatch is treated as a
miss, never as a hit.

Eviction is LRU over LEAF nodes (insert/lookup touch every node on the
path, so a parent is always at least as recent as its children);
evicting a node only drops the index's pin — a block still referenced
by a resident request stays until that request finishes.

Port: a copy of `paddle_tpu/inference/prefix_cache.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import hashlib

__all__ = ["PrefixCacheIndex", "chain_keys", "affinity_key"]


def chain_keys(identity, block_size, prompt):
    """The chained chunk keys for a prompt: one blake2b digest per FULL
    block-aligned chunk, each folding in the previous key so key i
    commits to every token before position (i+1)*block_size. Yields
    (key, chunk) pairs; `chunk` is the numpy token slice (for the
    collision check)."""
    h = hashlib.blake2b(identity.encode(), digest_size=16).digest()
    for i in range(int(prompt.size) // block_size):
        chunk = prompt[i * block_size:(i + 1) * block_size]
        h = hashlib.blake2b(h + chunk.tobytes(),
                            digest_size=16).digest()
        yield h, chunk


def affinity_key(identity, block_size, prompt):
    """The FIRST chunk's chain key (None for prompts shorter than one
    block) — the mesh router's prefix-affinity hint: requests whose
    prompts share their leading block hash to the same key and prefer
    the replica whose index already holds that prefix."""
    for key, _chunk in chain_keys(identity, block_size, prompt):
        return key
    return None


class _Node:
    __slots__ = ("key", "block", "tokens", "parent", "children",
                 "last_use")

    def __init__(self, key, block, tokens, parent, last_use):
        self.key = key
        self.block = block
        self.tokens = tokens          # raw chunk bytes: collision check
        self.parent = parent          # parent key (None at depth 0)
        self.children = set()         # child keys
        self.last_use = last_use


class PrefixCacheIndex:
    """identity: string folded into every chain key (model/format/block
    identity — entries can never resolve across a byte-layout change).
    max_blocks: optional hard cap on indexed blocks; inserts past it
    evict LRU leaves. The index never touches the pool itself — lookup/
    insert/evict return block ids and the ENGINE adjusts the pool's
    refcounts (pin/unpin), so this stays a pure host-side structure."""

    def __init__(self, identity, block_size, max_blocks=None):
        self.identity = str(identity)
        self.block_size = int(block_size)
        self.max_blocks = None if max_blocks is None else int(max_blocks)
        self._nodes: dict[bytes, _Node] = {}
        self._clock = 0

    def __len__(self):
        return len(self._nodes)

    def _touch(self, node):
        self._clock += 1
        node.last_use = self._clock

    def lookup(self, prompt):
        """Longest indexed prefix of `prompt`: ([block ids], matched
        tokens). Only FULL blocks match (matched tokens is always a
        multiple of block_size, possibly == prompt.size for a
        block-aligned full-prompt hit — the engine clamps the prefill
        tail to keep >= 1 real position). Touches every matched node
        (LRU recency)."""
        blocks = []
        for key, chunk in chain_keys(self.identity, self.block_size,
                                     prompt):
            node = self._nodes.get(key)
            if node is None or node.tokens != chunk.tobytes():
                break
            self._touch(node)
            blocks.append(node.block)
        return blocks, len(blocks) * self.block_size

    def insert(self, prompt, table):
        """Index every full-prompt block of a just-prefilled request:
        chunk i's node points at table[i]. Existing nodes are kept
        (their block already holds identical bytes) and touched; new
        nodes adopt the request's block. Returns the block ids of the
        NEW nodes — the caller pins each one (+1 refcount) so the block
        outlives the request."""
        new_blocks = []
        parent = None
        for i, (key, chunk) in enumerate(
                chain_keys(self.identity, self.block_size, prompt)):
            node = self._nodes.get(key)
            if node is not None:
                if node.tokens != chunk.tobytes():
                    break               # collision: never alias content
                self._touch(node)
            else:
                self._clock += 1
                node = _Node(key, int(table[i]), chunk.tobytes(),
                             parent, self._clock)
                self._nodes[key] = node
                if parent is not None and parent in self._nodes:
                    self._nodes[parent].children.add(key)
                new_blocks.append(node.block)
            parent = key
        return new_blocks

    def _remove(self, key):
        node = self._nodes.pop(key)
        if node.parent is not None and node.parent in self._nodes:
            self._nodes[node.parent].children.discard(key)
        return node.block

    def evict(self, protect=frozenset()):
        """Drop the least-recently-used LEAF node whose block is not in
        `protect` (blocks an in-flight admission is about to adopt).
        Returns the evicted block id (the caller unpins it), or None
        when nothing is evictable."""
        victim = None
        for key, node in self._nodes.items():
            if node.children or node.block in protect:
                continue
            if victim is None or node.last_use < victim[1].last_use:
                victim = (key, node)
        if victim is None:
            return None
        return self._remove(victim[0])

    def trim(self, protect=frozenset()):
        """Evict down to max_blocks (no-op when uncapped). Returns the
        list of unpinned block ids."""
        out = []
        if self.max_blocks is None:
            return out
        while len(self._nodes) > self.max_blocks:
            b = self.evict(protect)
            if b is None:
                break
            out.append(b)
        return out

    def clear(self):
        """Drop every entry (format/layout change: the stored bytes no
        longer mean what the keys promise). Returns all block ids for
        the caller to unpin."""
        blocks = [n.block for n in self._nodes.values()]
        self._nodes.clear()
        return blocks

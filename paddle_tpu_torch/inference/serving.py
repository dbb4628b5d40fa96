"""Continuous-batching serving engine over the paged KV cache.

reference: paddle_tpu/inference/serving.py — `Request` (:90),
`_LayeredBlockPool` (:174), `_PrefillTask`, `_Inflight`,
`ContinuousBatchingEngine` (:343) with its chunked prefill (:1324-1508),
its fused K-step decode (`_make_decode`, :2161), its speculative decode
(`_make_decode_spec`, :2292, `_ngram_draft`, :2487) and `_device_sample`
(:2514).

Three program families serve every request mix:

  - chunked prefill: a prompt is split into fixed-width chunks; each chunk
    forward writes its K/V into the paged pool and attends over every
    earlier position (`generation._llama_layer_prefill_chunk`), so a long
    prompt interleaves with decode tiles. It runs eagerly.
  - fused K-step decode: one program advances every lane `decode_steps`
    tokens: greedy argmax, per-lane sampling for sampled lanes, the paged
    writes and the EOS/length masking all on the device, returning a
    [B, K] token tile.
  - speculative decode: each of the K steps drafts `draft_depth` tokens
    per lane from the device-resident token history, verifies the step
    token and the drafts, commits the accepted run plus one correction
    token and rolls back the rejected writes, returning a [B, K, D + 2]
    tile: D + 1 tokens and the commit count of each step. Each verified
    position goes through the plain decode step's own operations (the same
    shapes, one token per lane), and the pages are gathered once per
    layer: the committed stream is the plain decode's bit for bit, in any
    dtype (the reference verifies all positions in one batched forward,
    which rounds differently in bf16).

On CUDA each decode program, keyed by (sampled, K, draft depth; 0 for the
plain decode), is captured once as a `torch.cuda.CUDAGraph` over static
lane-state and pool tensors, and each dispatch is one replay; a capture
that fails raises and the engine never decodes eagerly on the card. On the
CPU, which has no graphs, the same functions run eagerly.

Lane state (block tables, lengths, next tokens, alive mask, sampling
knobs, token history, adapter slots) is device-resident:
`_upload_lane_state` fills the static tensors in place only when lane
membership changes (`serving_lane_state_uploads_total`). Dispatch is
double-buffered: tile N+1 is enqueued before tile N is read back. Each
replay is followed by one non-blocking copy of its output to pinned host
memory under a CUDA event, which `_drain_one` waits on.

Memory is allocated in block_size granules from one (L, num_blocks, ...)
pool; the last block is the scratch target of dead lanes. Blocks are
refcounted so the prefix cache can share prompt blocks across requests.
Quantized formats (int8, fp8) keep a scale pool beside the payload.

The knobs: speculative decode (`drafting.py` for the pluggable drafters),
LoRA adapters (`adapters.py`), the SLO scheduler with preemption and the
brownout ladder (`scheduler.py`), the prefix cache (`prefix_cache.py`)
and quantized KV. Not ported: the mesh's export_kv / import_kv /
adopt_identity / prefill_sink (ROADMAP.md Queue 1, slice 4, step 6), which
raise NotImplementedError.

The cost model (reference :1397-1443, :1765-1767, :1886-1942): each
program is priced once by `pir.analysis.price` on its first run, which is
never a timed one: a prefill width on its first chunk, whose time is not
observed, and a decode program in the eager warm-up run of its capture
(on the CPU, its first dispatch, not observed either). The measured
dispatches after that calibrate the scale; `predicted_service_seconds` then
feeds the scheduler's headroom and loadgen's `slo_headroom`. On CUDA a
dispatch is measured by CUDA events around it, not by the host's wall:
around a decode graph's replay (device time; the wall from dispatch to
readback also holds the tile ahead of it), and around a prefill chunk
(the chunk's span on the stream, read once a later synchronisation has
passed it). On the card the port runs two kinds of program where the
reference runs one: a decode replays a captured graph, while a prefill
chunk is launched op by op from the host, whose launches it waits on. A
roofline scale fits one kind and not both, so each kind ("graph",
"eager") is calibrated by its own measured dispatches; on the CPU every
program is eager and one scale serves, as in the reference. A kind's
first measured dispatch sets its scale, as the reference's does, and its
next two refine it to the median of the three: an eager chunk's span
moves with the host's launches, and one slow chunk would otherwise skew
every later prediction.

Where the reference rebinds arrays functionally, this engine fills the
tensors that the captured graphs hold in place: adapter uploads, COW
forks and the lane state. The one exception is the kv-dequant
degradation, which makes a pool of another dtype: it drops every graph
and the next dispatch captures again.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import deque

import numpy as np
import torch

from ..generation import _llama_layer_prefill_chunk, _mlp, _rms, _rope
from ..observability import span as _span
from ..observability.catalog import metric as _metric
from ..observability.metrics import get_registry as _get_registry
from ..observability.recorder import get_recorder as _get_recorder
from ..observability.tracing import LANE_TID_BASE
from ..observability.tracing import get_tracer as _get_tracer
from ..observability.tracing import new_trace_id as _new_trace_id
from ..ops.flash_attention import kernel_takes
from ..ops.paged_attention import (KVBlockFormat, kv_rollback_tokens,
                                   kv_write_token, kv_write_tokens,
                                   paged_attention_decode_inner,
                                   paged_attention_verify)
from ..pir.analysis import price
from ..profiler.phases import get_phase_accountant as _get_phases
from ..resilience.faults import FaultInjected, fault_point
from .adapters import AdapterLoadError
from .drafting import _lookup
from .prefix_cache import PrefixCacheIndex
from .scheduler import PRIORITY_CLASSES, SLOScheduler

__all__ = ["ContinuousBatchingEngine", "Request", "BackpressureError",
           "KVPoolExhaustedError"]

# exception classes that mean "transient trouble, retry next step" when
# they surface from an admission / prefill-chunk / host-sync seam
_TRANSIENT_ERRORS = (TimeoutError, ConnectionError, OSError, FaultInjected)

# measured dispatches of one kind of program whose median sets its
# cost-model scale (_cost_observe)
CALIBRATION_DISPATCHES = 3


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, slice 4, step 6: "
        "the serving mesh)")


class BackpressureError(RuntimeError):
    """add_request refused: the admission queue is at max_queue. The
    caller should retry later or route away."""


class KVPoolExhaustedError(MemoryError):
    """The paged KV pool has no free block for a reservation: a typed
    MemoryError (counted in serving_pool_exhausted_total), so the
    shed/defer-on-MemoryError paths keep working."""


class Request:
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "generated", "done", "do_sample", "temperature", "top_k",
                 "top_p", "rng", "sample_seed", "t_arrival", "deadline_s",
                 "t_deadline", "finish_reason", "shed_count", "trace_id",
                 "tenant", "priority", "t_first", "adapter", "adapter_id")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=None, deadline_s=None, tenant="-",
                 priority="interactive", adapter=None):
        self.rid = rid
        # a named LoRA adapter (None = the base model); adapter_id is its
        # slot in the engine's AdapterStore, bound at admission (0 = base)
        self.adapter = str(adapter) if adapter else None
        self.adapter_id = 0
        self.tenant = str(tenant) if tenant else "-"
        self.priority = priority
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.generated: list[int] = []
        self.done = False
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        # None -> OS entropy; a fixed seed feeds the host RandomState (the
        # first token, sampled at prefill) and the device draw of every
        # decode token, a pure function of (seed, absolute position)
        self.rng = np.random.RandomState(seed)
        self.sample_seed = (np.uint32(seed & 0xFFFFFFFF)
                            if seed is not None else
                            np.uint32(int.from_bytes(os.urandom(4),
                                                     "little")))
        self.t_arrival = time.perf_counter()   # TTFT anchor
        self.t_first = None                    # first-token wall time
        # finish_reason is one of eos / length / timeout / shed /
        # rejected (None while live)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.t_deadline = (None if deadline_s is None
                           else self.t_arrival + float(deadline_s))
        self.finish_reason = None
        self.shed_count = 0
        self.trace_id = _new_trace_id("req-")

    def choose(self, logits: np.ndarray) -> int:
        """Per-request choice of the FIRST token on the host (decode tokens
        are chosen on the device): temperature -> top-k -> nucleus ->
        categorical."""
        if not self.do_sample:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / max(self.temperature, 1e-6)
        if self.top_k > 0:
            kth = np.sort(z)[-min(self.top_k, z.size)]
            z = np.where(z < kth, -np.inf, z)
        if self.top_p < 1.0:
            p = np.exp(z - np.max(z))
            p /= p.sum()
            order = np.argsort(-p)
            cum = np.cumsum(p[order])
            keep_sorted = (cum - p[order]) < self.top_p
            keep_sorted[0] = True  # top_p=0 must still keep the argmax
            keep = np.zeros_like(keep_sorted)
            keep[order] = keep_sorted
            z = np.where(keep, z, -np.inf)
        p = np.exp(z - np.max(z))
        p /= p.sum()
        return int(self.rng.choice(p.size, p=p))


class _LayeredBlockPool:
    """Block allocator over a (L, num_blocks, block_size, KVH, D) pool; one
    block-id table per sequence, shared by all layers. The last block is
    the scratch target of dead decode lanes.

    Blocks are REFCOUNTED: a block's references are each request whose
    table holds it and an optional prefix-cache pin (`pin`/`unpin`).
    `release` decrements, so requests sharing a prompt prefix return a
    block once, when the last holder lets go. Shared blocks are only read;
    the one write that can land in one (the tail of a block-aligned
    full-prefix match) goes through `fork_cow` first.

    Quantized formats hold int8/fp8 payloads plus a parallel
    (L, num_blocks, block_size, KVH) scale pool."""

    def __init__(self, num_layers, num_blocks, block_size, kv_heads,
                 head_dim, dtype, device, fmt=None):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.fmt = fmt if fmt is not None else KVBlockFormat(
            "native", native_dtype=dtype)
        store = self.fmt.store_dtype if self.fmt.quantized else dtype
        shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=store, device=device)
        self.v = torch.zeros(shape, dtype=store, device=device)
        if self.fmt.quantized:
            sshape = shape[:-1]
            self.k_scale = torch.zeros(sshape, dtype=self.fmt.scale_dtype,
                                       device=device)
            self.v_scale = torch.zeros_like(self.k_scale)
        else:
            self.k_scale = self.v_scale = None
        self.scratch_block = num_blocks - 1
        self._free = list(range(num_blocks - 2, -1, -1))
        self.tables: dict[int, list[int]] = {}
        # block id -> reference count; absent == free (on self._free)
        self._ref: dict[int, int] = {}

    def blocks_needed(self, n_tokens):
        return (n_tokens + self.block_size - 1) // self.block_size

    def can_fit(self, n_tokens, have=0):
        return len(self._free) >= self.blocks_needed(n_tokens) - have

    def _deref(self, b):
        n = self._ref.get(b, 1) - 1
        if n <= 0:
            self._ref.pop(b, None)
            self._free.append(b)
        else:
            self._ref[b] = n

    def ensure(self, rid, n_tokens):
        table = self.tables.setdefault(rid, [])
        need = self.blocks_needed(n_tokens)
        while len(table) < need:
            if not self._free:
                _metric("serving_pool_exhausted_total").inc()
                raise KVPoolExhaustedError("paged KV pool exhausted")
            b = self._free.pop()
            self._ref[b] = 1
            table.append(b)
        return table

    def release(self, rid):
        for b in self.tables.pop(rid, []):
            self._deref(b)

    # --- cross-request prefix sharing -----------------------------------
    def adopt(self, rid, blocks):
        """Start rid's table with already-resident shared blocks (a
        prefix-cache hit): each gains a reference; ensure() fills the
        rest."""
        table = self.tables.setdefault(rid, [])
        if table:
            raise ValueError(f"adopt on rid {rid} with a non-empty table")
        for b in blocks:
            self._ref[b] = self._ref.get(b, 0) + 1
            table.append(int(b))
        return table

    def pin(self, b):
        """Prefix-cache reference: keeps the block resident after its
        request retires."""
        self._ref[b] = self._ref.get(b, 0) + 1

    def unpin(self, b):
        """Drop a prefix-cache reference (index eviction / clear). The
        block frees only when no request still holds it."""
        self._deref(b)

    def shared_count(self, rid):
        """How many of rid's blocks are shared (refcount > 1)."""
        return sum(1 for b in self.tables.get(rid, ())
                   if self._ref.get(b, 1) > 1)

    def fork_cow(self, rid, idx):
        """Copy-on-write: give rid a PRIVATE copy of table[idx] before a
        write lands in it. The payload (and scales) are copied byte for
        byte into a fresh block IN PLACE in the pool tensors, whose
        addresses the captured decode graphs hold; the table entry swaps
        and the old reference drops. No-op when the block is already
        private. Raises KVPoolExhaustedError when no block is free."""
        old = self.tables[rid][idx]
        if self._ref.get(old, 1) <= 1:
            return old
        if not self._free:
            _metric("serving_pool_exhausted_total").inc()
            raise KVPoolExhaustedError(
                "paged KV pool exhausted (copy-on-write fork)")
        new = self._free.pop()
        self._ref[new] = 1
        pools = [self.k, self.v]
        if self.fmt.quantized:
            pools += [self.k_scale, self.v_scale]
        for pool in pools:
            pool[:, new].copy_(pool[:, old])
        self.tables[rid][idx] = new
        self._deref(old)
        return new


class _PrefillTask:
    """A prompt being prefilled chunk by chunk: `pieces` is the (start,
    width) plan; the task owns its lane, which is occupied but not
    decode-active until the final chunk completes."""

    __slots__ = ("req", "lane", "pieces", "idx")

    def __init__(self, req, lane, pieces):
        self.req = req
        self.lane = lane
        self.pieces = pieces
        self.idx = 0


class _Inflight:
    """One dispatched-but-unread decode tile: its output (a pinned host
    tensor on CUDA, filled under `event`) plus the lane snapshot (request
    refs + lane epochs) that credits tokens only to lanes whose occupancy
    did not change while the tile was in flight. `spec` marks a
    speculative tile ([B, K, D + 2]: tokens and commit counts); it is per
    tile, so tiles dispatched before a switch drain under the program
    they ran. `key` is the compile_reports key of the dispatched program,
    None for a cold dispatch (a capture or a priced run), whose time the
    cost model does not read; `span` the CUDA events around a replay (None
    on the CPU, where the wall is read)."""

    __slots__ = ("tile", "event", "t_dispatch", "reqs", "epochs", "k",
                 "covers_all", "tile_id", "spec", "key", "span")

    def __init__(self, tile, event, t_dispatch, reqs, epochs, k, covers_all,
                 tile_id=0, spec=False, key=None, span=None):
        self.key = key
        self.span = span
        self.tile = tile
        self.event = event
        self.t_dispatch = t_dispatch
        self.reqs = reqs
        self.epochs = epochs
        self.k = k
        self.covers_all = covers_all
        self.tile_id = tile_id
        self.spec = spec


class _DecodeGraph:
    """One captured decode program: its graph and its static output."""

    __slots__ = ("graph", "tile")

    def __init__(self, graph, tile):
        self.graph = graph
        self.tile = tile


class ContinuousBatchingEngine:
    """Iteration-level scheduler: admit -> fused decode tile -> retire.

    model: LlamaForCausalLM of this package, on the device the engine
    serves from (CUDA, or the CPU when the model was built there).
    Per-request knobs (greedy by default; do_sample with temperature,
    top_k, top_p and a per-request seed) ride the device-resident lane
    state, so mixed greedy and sampled lanes share one decode program.

    Knobs:
      decode_steps: tokens every lane advances per dispatch (the K of the
        fused program). 1 reproduces the step-per-token engine.
      prefill_chunk: max prompt tokens per prefill chunk (default: the
        largest prefill bucket; longer prompts chunk).
      prefill_chunks_per_step: chunks advanced per engine step while
        decode lanes are active (back to back when none are).
      compat_step_loop: the pre-fused host-bound loop — decode_steps 1,
        lane state uploaded every step, every tile drained synchronously,
        never speculative.
      speculative_decode: each of the K steps proposes draft_depth tokens
        from the drafter, verifies them, and commits the accepted run plus
        a correction token — up to K * (draft_depth + 1) tokens per
        dispatch; streams are the plain decode's.
      draft_depth: draft tokens per step (clamped to block_size - 1, so
        one step's writes and their rollback never alias within a block).
      draft_ngram: context length of the built-in prompt-lookup drafter.
      drafter: `fn(hist, lens, toks, depth) -> [B, depth]` int64 tensor of
        drafts, run inside the decode program (see drafting.py); None =
        the built-in n-gram drafter.
      kv_cache_dtype: the pool's block format: "bf16"/"native" (the model
        dtype), "int8", "fp8_e4m3", "fp8_e5m2" (quantized payloads and
        per-(token, head) scales, dequantized at the attention reads).
      kv_pool_bytes: size the pool by a byte budget instead of num_blocks;
        int8 fits about twice the blocks of bf16.
      max_queue / max_sheds: backpressure and shed limits.
      scheduler: the SLO scheduler (scheduler.SLOScheduler): priority
        classes with decode-lane preemption, per-tenant DRR and quotas,
        and the reversible brownout ladder. None = FIFO admission; True =
        an SLOScheduler with defaults; or a configured instance.
      prefix_cache: cross-request prompt-prefix sharing: admission
        resolves the prompt's leading block-aligned chunks against a
        chained-hash index of resident blocks, prefill runs only on the
        tail, shared blocks are refcounted, and the tail of a
        block-aligned full match forks a private copy first (COW). Index
        failures degrade to a miss (the serve.prefix_match fault site).
      prefix_cache_blocks: optional cap on indexed blocks (LRU-evicted);
        None = bounded by pool pressure only.
      adapters: an adapters.AdapterStore on the engine's device. Lanes
        carry an adapter slot, and the prefill and decode programs add
        each lane's LoRA delta (slot 0, the base model, adds exactly 0).
    """

    def __init__(self, model, num_blocks=256, block_size=16, max_batch=8,
                 max_blocks_per_seq=64,
                 prefill_buckets=(64, 128, 256, 512, 1024),
                 max_queue=None, max_sheds=2, decode_steps=4,
                 prefill_chunk=None, prefill_chunks_per_step=1,
                 compat_step_loop=False, speculative_decode=False,
                 draft_depth=2, draft_ngram=3, drafter=None,
                 kv_cache_dtype="bf16", kv_pool_bytes=None,
                 scheduler=None, prefix_cache=False,
                 prefix_cache_blocks=None, adapters=None):
        config = model.config
        self.cfg = dict(eps=config.rms_norm_eps, theta=config.rope_theta,
                        heads=config.num_attention_heads,
                        kv_heads=config.num_key_value_heads,
                        head_dim=(config.hidden_size //
                                  config.num_attention_heads))
        # the model's own per-layer parameters: stacking them, as the
        # reference does, would copy the weights
        self.layers = [dict(layer.named_parameters())
                       for layer in model.llama.layers]
        self.embed_w = model.llama.embed_tokens.weight
        self.norm_w = model.llama.norm.weight
        self._out_w = (self.embed_w.T if model.lm_head is None
                       else model.lm_head.weight)
        self.device = self.embed_w.device
        dtype = self.embed_w.dtype
        L = config.num_hidden_layers
        fmt = KVBlockFormat(kv_cache_dtype, native_dtype=dtype)
        if kv_pool_bytes is not None:
            # blocks = budget / bytes per block (k and v, all layers,
            # payload and scales)
            per_block = (L * block_size * 2 *
                         fmt.bytes_per_token(self.cfg["kv_heads"],
                                             self.cfg["head_dim"]))
            num_blocks = max(2, int(kv_pool_bytes) // per_block)
        self.pool = _LayeredBlockPool(L, num_blocks, block_size,
                                      self.cfg["kv_heads"],
                                      self.cfg["head_dim"], dtype,
                                      self.device, fmt=fmt)
        self.max_batch = int(max_batch)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.buckets = tuple(sorted(prefill_buckets))
        self.compat_step_loop = bool(compat_step_loop)
        self.decode_steps = (1 if self.compat_step_loop
                             else max(1, int(decode_steps)))
        self.spec = bool(speculative_decode) and not self.compat_step_loop
        self.draft_depth = max(1, min(int(draft_depth), block_size - 1))
        self.draft_ngram = max(2, int(draft_ngram))
        self._drafter = drafter
        self.chunk = int(prefill_chunk or self.buckets[-1])
        self.prefill_chunks_per_step = max(1, int(prefill_chunks_per_step))
        # chunk widths a prefill piece may run at: every bucket that fits
        # inside a chunk, plus the chunk width itself
        self._chunk_widths = sorted(
            {b for b in self.buckets if b <= self.chunk} | {self.chunk})
        # the router's decision at the largest chunk width, for audit only:
        # the prefill attention is paged_attention_prefill_chunk, never the
        # flash kernels. Not asked where the kernels cannot take the dtype
        # (a live measurement would launch them on it)
        self.attention_route = None
        if self.device.type != "cuda" or kernel_takes(
                dtype, self.cfg["head_dim"]):
            try:
                from ..ops.attention_router import route
                self.attention_route = route(
                    self.cfg["heads"], self._chunk_widths[-1],
                    self._chunk_widths[-1], self.cfg["head_dim"], dtype,
                    True, platform=self.device.type)
            except (ImportError, OSError, ValueError, KeyError) as e:
                warnings.warn(
                    f"serving attention-route probe failed ({e!r})",
                    RuntimeWarning, stacklevel=2)
                _metric("serving_route_probe_failures_total").inc()
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_sheds = int(max_sheds)
        self.lanes: list[Request | None] = [None] * self.max_batch
        self.lane_len = np.zeros(self.max_batch, np.int64)  # tokens in cache
        self.lane_tok = np.zeros(self.max_batch, np.int64)  # next to write
        # occupancy epoch per lane: bumped on every retire/shed/assign so an
        # in-flight tile never credits tokens across an occupancy change
        self._lane_epoch = np.zeros(self.max_batch, np.int64)
        self.queue: deque[Request] = deque()
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self._prefill_tasks: dict[int, _PrefillTask] = {}
        # device-resident lane state: static tensors that the decode
        # graphs read and write, refilled in place by _upload_lane_state
        # only on membership change (self._dirty)
        B, MB = self.max_batch, self.max_blocks_per_seq

        def _zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        self._dev = dict(
            toks=_zeros(B), lens=_zeros(B), alive=_zeros(B, dtype=torch.bool),
            rem=_zeros(B), eos=_zeros(B), tables=_zeros(B, MB),
            seeds=_zeros(B), do_sample=_zeros(B, dtype=torch.bool),
            temp=_zeros(B, dtype=torch.float32), top_k=_zeros(B),
            top_p=_zeros(B, dtype=torch.float32))
        if self.spec:
            # each lane's prompt and committed tokens, the drafter's corpus;
            # the last column is the scratch target of dead lanes' and
            # out-of-range writes (the reference's JAX drops them)
            self._dev["hist"] = _zeros(B, MB * block_size + 1)
        self._variant = None      # "greedy"|"sampled"[".spec"] once uploaded
        self._dirty = True
        self._inflight: deque[_Inflight] = deque()
        # (sampled, K, draft depth; 0 = plain decode) -> captured program
        # (CUDA only); the graphs share one memory pool, as they never run
        # at once, and every output the host reads is copied out right
        # after its replay
        self._graphs: dict[tuple, _DecodeGraph] = {}
        self._graph_pool = None
        self._adapters = None
        self.adapters = adapters
        self.graph_captures = 0
        self.program_keys_used: set[tuple] = set()
        # cost-model key ("prefill.b{width}", "decode[.sampled][.spec]")
        # -> the program's ProgramCost; the first measured dispatches of
        # each kind of program (_cost_kind) set that kind's _cost_scale
        # entry (None: uncalibrated; _cost_samples holds the dispatches)
        self.compile_reports: dict = {}
        self._cost_scale = None
        self._cost_samples: dict = {}
        # (key, start, end) CUDA events of prefill chunks not yet read
        self._prefill_spans = deque()
        self._m_cost_err = _metric("pir_cost_model_error")
        # observability handles bound once (catalog names; no-ops while
        # the layer is disabled)
        self._m_ttft = _metric("serving_ttft_seconds")
        self._m_tpot = _metric("serving_tpot_seconds")
        self._m_prefill = _metric("serving_prefill_seconds")
        self._m_queue = _metric("serving_queue_depth")
        self._m_occ = _metric("serving_batch_occupancy")
        self._m_free = _metric("serving_kv_free_blocks")
        self._m_admitted = _metric("serving_admitted_total")
        self._m_retired = _metric("serving_retired_total")
        self._m_tokens = _metric("serving_tokens_total")
        self._m_uploads = _metric("serving_lane_state_uploads_total")
        self._m_dispatches = _metric("serving_decode_dispatches_total")
        self._m_ahead = _metric("serving_dispatch_ahead_depth")
        self._m_hostsync = _metric("serving_hostsync_seconds")
        self._m_hostsync_retries = _metric("serving_hostsync_retries_total")
        self._m_chunks = _metric("serving_prefill_chunks_total")
        self._m_draft = _metric("serving_draft_tokens_total")
        self._m_accept = _metric("serving_accepted_tokens_total")
        self._m_accept_rate = _metric("serving_spec_acceptance_rate")
        self._m_tok_disp = _metric("serving_tokens_per_dispatch")
        _metric("serving_preempted_total")  # incremented by _try_preempt
        self._tracer = _get_tracer()
        self._reg = _get_registry()
        self._rec = _get_recorder()
        self._tile_seq = 0              # decode tile ids for span links
        self._phases = _get_phases()
        # bounded-cardinality tenant label set: past the cap new tenants
        # collapse to "overflow"
        self._tenants: set[str] = set()
        self._max_tenants = 32
        # the brownout ladder's base values, so its degradations are
        # reversible; _spec_allowed separates the reversible switch from
        # the permanent draft_verify-fault degradation
        self._base_decode_steps = self.decode_steps
        self._base_draft_depth = self.draft_depth
        self._base_chunk = self.chunk
        self._mnt_cap = None
        self._spec_allowed = self.spec
        # rid -> (request, cached length, next token): decode lanes parked
        # by preemption; their blocks stay allocated, so a resume is a
        # lane-state upload, not a prefill
        self._preempted: dict[int, tuple[Request, int, int]] = {}
        # arrival times (trailing window): the scheduler's offered rate
        self._arrivals: deque[float] = deque(maxlen=256)
        if scheduler is True:
            scheduler = SLOScheduler()
        self.scheduler = scheduler
        # the prefix index; its identity string folds the block format and
        # geometry into every chain key, so entries never resolve across a
        # format change (the kv_dequant degradation also clears it)
        if prefix_cache:
            ident = (f"{self.pool.fmt.name}:{block_size}:"
                     f"{self.cfg['kv_heads']}x{self.cfg['head_dim']}:"
                     f"{str(dtype).removeprefix('torch.')}")
            self._prefix = PrefixCacheIndex(ident, block_size,
                                            max_blocks=prefix_cache_blocks)
        else:
            self._prefix = None
        # rid -> tokens resolved from the index at admission
        self._prefix_matched: dict[int, int] = {}
        self._m_pfx_hits = _metric("serving_prefix_hits_total")
        self._m_pfx_miss = _metric("serving_prefix_misses_total")
        self._m_pfx_saved = _metric("serving_prefix_tokens_saved_total")
        self._m_pfx_shared = _metric("serving_prefix_shared_blocks")
        self._m_pfx_evict = _metric("serving_prefix_evictions_total")
        self._m_pfx_cow = _metric("serving_prefix_cow_forks_total")

    @property
    def adapters(self):
        """The engine's AdapterStore, or None."""
        return self._adapters

    @adapters.setter
    def adapters(self, store):
        """Attach an AdapterStore, checked against the model, before the
        first decode capture (a captured program holds no adapter slots);
        loadgen attaches its demo store so to a cold engine."""
        if self._graphs and (store is None) != (self._adapters is None):
            raise ValueError(
                "attach or detach the AdapterStore before the first "
                "decode: the captured decode programs are built with or "
                "without adapter slots")
        if store is None:
            self._dev.pop("adapter_ids", None)
        else:
            L = len(self.layers)
            nh, nkv, hd = (self.cfg["heads"], self.cfg["kv_heads"],
                           self.cfg["head_dim"])
            H = nh * hd
            if (store.num_layers != L or store.hidden != H
                    or store.q_out != nh * hd or store.v_out != nkv * hd):
                raise ValueError(
                    "AdapterStore dimensions do not match this model: "
                    f"store (L={store.num_layers}, H={store.hidden},"
                    f" q={store.q_out}, v={store.v_out}) vs model "
                    f"(L={L}, H={H}, q={nh * hd}, v={nkv * hd})")
            if store.device != self.device:
                raise ValueError(
                    f"AdapterStore lives on {store.device}, the engine "
                    f"on {self.device}")
            if "adapter_ids" not in self._dev:
                self._dev["adapter_ids"] = torch.zeros(
                    self.max_batch, dtype=torch.int64, device=self.device)
                self._dirty = True
        self._adapters = store

    # --- public API -------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                    seed=0, deadline_s=None, tenant="-",
                    priority="interactive", adapter=None):
        """Queue a request; returns its id. `deadline_s` is a wall-clock
        budget from arrival: once exceeded the request finishes with what
        it has and finish_reason='timeout'. `tenant` labels its telemetry
        (bounded cardinality). `priority` must name a class of
        scheduler.PRIORITY_CLASSES (only a scheduler reads it). `adapter`
        names a LoRA adapter of the engine's AdapterStore (None = base);
        one the store cannot make resident at admission is a typed
        rejection, never a base-weights stream. Raises BackpressureError
        when the admission queue is at max_queue."""
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {priority!r}; registered: "
                f"{list(PRIORITY_CLASSES)}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            _metric("serving_backpressure_total").inc()
            if self._rec.enabled:
                self._rec.record("backpressure", queue=len(self.queue),
                                 max_queue=self.max_queue)
            raise BackpressureError(
                f"admission queue full ({len(self.queue)}/{self.max_queue}); "
                "retry later")
        tenant = str(tenant) if tenant else "-"
        if tenant != "-" and tenant not in self._tenants:
            if len(self._tenants) >= self._max_tenants:
                tenant = "overflow"
            else:
                self._tenants.add(tenant)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, eos_token_id,
                      do_sample, temperature, top_k, top_p,
                      seed, deadline_s, tenant=tenant, priority=priority,
                      adapter=adapter)
        self.queue.append(req)
        self._arrivals.append(req.t_arrival)
        if self._tracer.enabled:
            self._tracer.add_span("request.admit",
                                  int(req.t_arrival * 1e9), 0,
                                  trace_id=req.trace_id, args={"rid": rid})
        return rid

    def has_work(self):
        return (bool(self.queue) or any(r is not None for r in self.lanes)
                or bool(self._inflight) or bool(self._preempted))

    def run(self, max_steps=10_000):
        """Drive to completion; returns {rid: [generated tokens]}."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return {rid: r.generated for rid, r in self.finished.items()}

    def export_kv(self, req, first_tok):
        raise _not_ported("export_kv")

    def import_kv(self, record):
        raise _not_ported("import_kv")

    def adopt_identity(self, rid, trace_id, t_arrival=None):
        raise _not_ported("adopt_identity")

    @property
    def prefill_sink(self):
        """The disaggregated prefill worker's hand-off; always None here."""
        return None

    @prefill_sink.setter
    def prefill_sink(self, sink):
        if sink is not None:
            raise _not_ported("prefill_sink")

    # --- static cost model (pir/analysis.py) ------------------------------
    def _cost_kind(self, key):
        """The kind of program compile_reports[key] is, each calibrated
        on its own: on the card a decode replays a captured graph and a
        prefill chunk runs eagerly; on the CPU every program is eager."""
        if self.device.type == "cuda" and key.startswith("decode"):
            return "graph"
        return "eager"

    def _cost_observe(self, key, dt):
        """Predicted-vs-measured cost of one dispatch of the program
        compile_reports[key]. The first CALIBRATION_DISPATCHES measured
        dispatches of a kind of program set that kind's scale to the
        median of their measured over raw costs (the first alone sets it,
        so its ratio is 1.0); every dispatch updates the per-program
        ratio gauge and the pooled error histogram whose exemplar carries
        the worst-predicted program."""
        cost = self.compile_reports.get(key)
        if cost is None or cost.raw_seconds <= 0 or dt <= 0:
            return
        if self._cost_scale is None:
            # (re)calibration starts: loadgen clears the scale after its
            # warm-up
            self._cost_scale, self._cost_samples = {}, {}
        kind = self._cost_kind(key)
        samples = self._cost_samples.setdefault(kind, [])
        if len(samples) < CALIBRATION_DISPATCHES:
            samples.append(dt / cost.raw_seconds)
            self._cost_scale[kind] = float(np.median(samples))
        ratio = dt / (cost.raw_seconds * self._cost_scale[kind])
        _metric("pir_cost_ratio", program=key).set(ratio)
        self._m_cost_err.observe(ratio, exemplar=key)

    def _observe_prefill_spans(self):
        """Observe the prefill chunks whose end event the stream has
        passed (each span's events are read once, in order)."""
        spans = self._prefill_spans
        while spans and spans[0][2].query():
            key, start, end = spans.popleft()
            self._cost_observe(key, start.elapsed_time(end) / 1e3)

    def predicted_costs(self):
        """{program key: {flops, bytes, raw_seconds, seconds}} for every
        priced program; `seconds` is the calibrated prediction (None until
        a dispatch calibrated its kind's scale). The loadgen harness
        derives its slo_headroom capacity signal from this."""
        scales = self._cost_scale or {}
        out = {}
        for key, cost in self.compile_reports.items():
            scale = scales.get(self._cost_kind(key))
            out[key] = {"flops": cost.flops, "bytes": cost.bytes,
                        "raw_seconds": cost.raw_seconds,
                        "seconds": (cost.raw_seconds * scale
                                    if scale else None)}
        return out

    def predicted_service_seconds(self, output_tokens=32):
        """Calibrated engine seconds one request of `output_tokens`
        consumes: its share of the fused decode dispatches (a tile
        advances all max_batch lanes together) plus one prefill chunk.
        None until the cost model is calibrated for both — callers fall
        back to measured throughput."""
        if self._cost_scale is None:
            return None
        costs = self.predicted_costs()
        decode = next((c for k, c in sorted(costs.items())
                       if k.startswith("decode")), None)
        if decode is None or decode["seconds"] is None:
            return None
        # priced against the BASE decode program (the calibrated report
        # belongs to it): the estimate stays a stable capacity signal
        # for the undegraded engine even while the brownout ladder has
        # decode_steps temporarily shrunk
        t = (output_tokens / self._base_decode_steps) \
            * decode["seconds"] / self.max_batch
        prefill = next((c for k, c in sorted(costs.items())
                        if k.startswith("prefill")), None)
        if prefill is not None:
            if prefill["seconds"] is None:
                return None
            t += prefill["seconds"]
        return t

    # --- scheduling -------------------------------------------------------
    @torch.no_grad()
    def step(self):
        ph = self._phases
        ph.begin_step()
        with _span("serving.step"):
            self._expire_deadlines()
            self._m_queue.set(len(self.queue))
            if self.scheduler is not None:
                # the closed-loop decision (brownout ladder and at most
                # one preemption): admission policy, timed as "admit"
                self.scheduler.on_step(self)
            self._admit()
            ph.mark("admit")
            self._run_prefill_tasks()
            self._decode_phase()
            self._m_occ.set(sum(r is not None for r in self.lanes)
                            / self.max_batch)
            self._m_free.set(len(self.pool._free))
        ph.end_step()

    def _decode_active(self):
        """Lanes the fused decode advances: occupied AND past prefill."""
        return [i for i, r in enumerate(self.lanes)
                if r is not None and i not in self._prefill_tasks]

    # --- graceful degradation --------------------------------------------
    def _finish(self, req, reason):
        # the one finish path: finish_reason, serving_finished_total, the
        # request.finish span and the recorder event share `reason`
        req.done = True
        req.finish_reason = reason
        self._prefix_matched.pop(req.rid, None)
        self.finished[req.rid] = req
        _metric("serving_finished_total", reason=reason).inc()
        _metric("serving_tenant_finished_total",
                tenant=req.tenant, reason=reason).inc()
        if self._tracer.enabled:
            self._tracer.add_span("request.finish",
                                  time.perf_counter_ns(), 0,
                                  trace_id=req.trace_id,
                                  args={"rid": req.rid, "reason": reason,
                                        "tokens": len(req.generated)})
        if self._rec.enabled:
            self._rec.record("finish", rid=req.rid, reason=reason,
                             tokens=len(req.generated))

    def _adapter_release(self, req):
        """Drop the request's adapter reference (idempotent): acquired at
        admission, held while parked, dropped wherever its blocks are
        released."""
        if self.adapters is not None and req.adapter_id:
            self.adapters.release(req.adapter_id)
        req.adapter_id = 0

    def _vacate(self, lane):
        """Empty a lane: its prefill task, its blocks, its adapter
        reference and its slot."""
        req = self.lanes[lane]
        self._prefill_tasks.pop(lane, None)
        self.pool.release(req.rid)
        self._adapter_release(req)
        self.lanes[lane] = None
        self.lane_len[lane] = 0
        self._lane_epoch[lane] += 1
        self._dirty = True
        return req

    def _retire_lane(self, lane, reason):
        req = self._vacate(lane)
        self._m_retired.inc()
        self._finish(req, reason)

    def _expire_deadlines(self):
        """An expired queued request finishes empty; an expired decoding,
        prefilling or parked request finishes with the tokens it has and
        releases its blocks."""
        now = time.perf_counter()
        if any(r.t_deadline is not None and now >= r.t_deadline
               for r in self.queue):
            kept = deque()
            for req in self.queue:
                if req.t_deadline is not None and now >= req.t_deadline:
                    _metric("serving_timeouts_total", where="queue").inc()
                    if self._rec.enabled:
                        self._rec.record("timeout", rid=req.rid,
                                         where="queue")
                    self._finish(req, "timeout")
                else:
                    kept.append(req)
            self.queue = kept
        for lane, req in enumerate(self.lanes):
            if (req is not None and req.t_deadline is not None
                    and now >= req.t_deadline):
                _metric("serving_timeouts_total", where="decode").inc()
                if self._rec.enabled:
                    self._rec.record("timeout", rid=req.rid, where="decode")
                self._retire_lane(lane, "timeout")
        for rid in [rid for rid, (req, _ln, _tok)
                    in self._preempted.items()
                    if req.t_deadline is not None
                    and now >= req.t_deadline]:
            req, _ln, _tok = self._preempted.pop(rid)
            self.pool.release(rid)
            self._adapter_release(req)
            _metric("serving_timeouts_total", where="preempted").inc()
            if self._rec.enabled:
                self._rec.record("timeout", rid=rid, where="preempted")
            self._m_retired.inc()
            self._finish(req, "timeout")

    def cancel(self, rid):
        """Withdraw one request wherever it lives (queued, in a lane or
        parked) without a finished record; its blocks release. Returns
        whether anything was withdrawn."""
        rid = int(rid)
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                break
        else:
            lane = next((i for i, r in enumerate(self.lanes)
                         if r is not None and r.rid == rid), None)
            if lane is not None:
                self._vacate(lane)
            elif rid in self._preempted:
                req, _ln, _tok = self._preempted.pop(rid)
                self.pool.release(rid)
                self._adapter_release(req)
            else:
                return False
        self._prefix_matched.pop(rid, None)
        if self._rec.enabled:
            self._rec.record("sched", action="cancel", rid=rid)
        return True

    def _shed(self, active):
        """Decode OOM: preempt the lane with the least work done, release
        its blocks, and requeue the request at the FRONT of the queue for
        a fresh prefill; past max_sheds it finishes with
        finish_reason='shed'."""
        self._dirty = True
        if not active:
            return
        victim = max(active,
                     key=lambda i: (-len(self.lanes[i].generated), i))
        req = self._vacate(victim)
        req.shed_count += 1
        _metric("serving_shed_total").inc()
        if self._rec.enabled:
            self._rec.record("shed", rid=req.rid, lane=victim,
                             sheds=req.shed_count)
        if req.shed_count > self.max_sheds:
            self._m_retired.inc()
            self._finish(req, "shed")
            return
        # greedy decode reproduces the same prefix, and sampled lanes
        # re-derive the same stream from (seed, position)
        req.generated = []
        self.queue.appendleft(req)

    # --- priority preemption ----------------------------------------------
    def _try_preempt(self, lane, why="slo"):
        """Park a decode-active lane so a higher-priority request can take
        it. Unlike _shed, the blocks STAY resident and the host cursor
        (lane_len / lane_tok) is saved: resuming is a lane-state upload,
        and the stream continues as it would have. Tokens of the lane in a
        tile still in flight are regenerated identically after the resume
        (the tile wrote the same values to the same positions); the epoch
        bump keeps them from being credited twice. Returns False when the
        lane is empty or still prefilling, or the serve.preempt fault site
        fires (the victim keeps decoding)."""
        req = self.lanes[lane]
        if req is None or lane in self._prefill_tasks:
            return False
        try:
            fault_point("serve.preempt", rid=req.rid, lane=lane)
        except _TRANSIENT_ERRORS:
            _metric("serving_deferred_total", reason="preempt_fault").inc()
            return False
        self._preempted[req.rid] = (req, int(self.lane_len[lane]),
                                    int(self.lane_tok[lane]))
        self.lanes[lane] = None
        self.lane_len[lane] = 0
        self._lane_epoch[lane] += 1
        self._dirty = True
        _metric("serving_preempted_total").inc()
        _metric("serving_preemptions_total",
                **{"class": req.priority}).inc()
        if self._rec.enabled:
            self._rec.record("sched", action="preempt", rid=req.rid,
                             lane=lane, why=why,
                             tokens=len(req.generated))
        if self._tracer.enabled:
            self._tracer.add_span("request.preempt",
                                  time.perf_counter_ns(), 0,
                                  trace_id=req.trace_id,
                                  args={"rid": req.rid, "why": why})
        return True

    def _resume_preempted(self):
        """Re-admit parked requests into free lanes, oldest first: the host
        cursor comes back, the epoch bumps, and the next _decode_phase
        uploads the lane state."""
        for rid in list(self._preempted):
            lane = next((i for i, r in enumerate(self.lanes)
                         if r is None and i not in self._prefill_tasks),
                        None)
            if lane is None:
                return
            req, lane_len, lane_tok = self._preempted.pop(rid)
            self.lanes[lane] = req
            self.lane_len[lane] = lane_len
            self.lane_tok[lane] = lane_tok
            self._lane_epoch[lane] += 1
            self._dirty = True
            if self._rec.enabled:
                self._rec.record("sched", action="resume", rid=rid,
                                 lane=lane, tokens=len(req.generated))

    # --- admission / chunked prefill -------------------------------------
    def _admit(self):
        """Reserve a lane and the request's whole block footprint; the
        prompt prefills chunk by chunk in _run_prefill_tasks. With a
        scheduler, parked requests resume first when it allows, and the
        queue order comes from its priority-class and tenant-DRR pick
        instead of FIFO."""
        if self._preempted and (self.scheduler is None
                                or self.scheduler.should_resume(self)):
            self._resume_preempted()
        while self.queue:
            free_lanes = [i for i, r in enumerate(self.lanes) if r is None]
            if not free_lanes:
                return
            if self.scheduler is not None:
                idx = self.scheduler.pick_index(self)
                if idx is None:
                    return
            else:
                idx = 0
            req = self.queue[idx]
            if (self.scheduler is not None
                    and self.scheduler.shed_best_effort
                    and req.priority == "best_effort"):
                # deepest brownout rung: best_effort is not served; a
                # typed, counted shed
                del self.queue[idx]
                req.generated = []
                _metric("serving_shed_total").inc()
                if self._rec.enabled:
                    self._rec.record("sched", action="shed_best_effort",
                                     rid=req.rid)
                self._finish(req, "shed")
                continue
            if self._mnt_cap is not None \
                    and req.max_new_tokens > self._mnt_cap:
                # cap_max_new_tokens rung: the budget is reshaped at
                # admission and stays so after recovery
                req.max_new_tokens = self._mnt_cap
                if self._rec.enabled:
                    self._rec.record("sched", action="cap_max_new_tokens",
                                     rid=req.rid, cap=self._mnt_cap)
            total = req.prompt.size + req.max_new_tokens
            if total > self.max_blocks_per_seq * self.pool.block_size:
                # cannot ever serve: rejected with an empty result
                del self.queue[idx]
                req.generated = []
                self._finish(req, "rejected")
                _metric("serving_rejected_total", reason="oversized").inc()
                continue
            if req.max_new_tokens <= 0:
                del self.queue[idx]
                self._finish(req, "length")
                continue
            # prefix-cache lookup: the prompt's leading block-aligned
            # chunks resolved to resident shared blocks; any index failure
            # is a plain miss (full prefill, the same stream)
            matched, m_tok = [], 0
            s = int(req.prompt.size)
            if self._prefix is not None:
                try:
                    fault_point("serve.prefix_match", rid=req.rid)
                    matched, m_tok = self._prefix.lookup(req.prompt)
                except _TRANSIENT_ERRORS:
                    matched, m_tok = [], 0
                    _metric("serving_runtime_degradations_total",
                            what="prefix_miss").inc()
                    if self._rec.enabled:
                        self._rec.record("degrade", what="prefix_miss",
                                         rid=req.rid)
            # a block-aligned FULL match must still prefill the final
            # position (the first token comes from its logits): that one
            # write lands in the last shared block, which is forked first
            need_fork = bool(matched) and m_tok >= s
            if need_fork:
                m_tok = s - 1
            # admit only if the WHOLE sequence fits (no mid-flight eviction
            # of live requests); index-only blocks are reclaimable cache,
            # evicted LRU before deferring
            have = len(matched) - (1 if need_fork else 0)

            def _fits():
                return (self.pool.can_fit(total, have) if have
                        else self.pool.can_fit(total))

            if not _fits() and self._prefix is not None:
                protect = frozenset(matched)
                while not _fits():
                    b = self._prefix.evict(protect)
                    if b is None:
                        break
                    self.pool.unpin(b)
                    self._m_pfx_evict.inc()
                self._m_pfx_shared.set(len(self._prefix))
            if not _fits():
                _metric("serving_deferred_total", reason="pool_full").inc()
                return
            del self.queue[idx]
            # adapter binding: make the named adapter resident and check
            # the slot the lane will gather from. Any store failure is a
            # typed rejection, never a stream on the wrong weights
            req.adapter_id = 0
            if req.adapter:
                try:
                    fault_point("serve.adapter_load", rid=req.rid,
                                adapter=req.adapter)
                    if self.adapters is None:
                        raise AdapterLoadError(
                            f"request names adapter {req.adapter!r} but "
                            "the engine has no AdapterStore attached")
                    req.adapter_id = self.adapters.acquire(req.adapter)
                    fault_point("serve.adapter_gather", rid=req.rid,
                                slot=req.adapter_id)
                    self.adapters.check_resident(req.adapter_id)
                except (AdapterLoadError,) + _TRANSIENT_ERRORS:
                    self._adapter_release(req)
                    req.generated = []
                    self._finish(req, "rejected")
                    _metric("serving_rejected_total",
                            reason="adapter").inc()
                    _metric("serving_adapter_load_failures_total").inc()
                    if self._rec.enabled:
                        self._rec.record("adapter", action="reject",
                                         rid=req.rid,
                                         adapter=req.adapter)
                    continue
            lane = free_lanes[0]
            try:
                fault_point("serve.admit", rid=req.rid)
                # reserve the FULL footprint now, so decode never exhausts
                # the pool mid-flight; matched blocks are adopted first
                if matched:
                    self.pool.adopt(req.rid, matched)
                    if need_fork:
                        self.pool.fork_cow(req.rid, len(matched) - 1)
                        self._m_pfx_cow.inc()
                self.pool.ensure(req.rid, total)
            except MemoryError:
                self.pool.release(req.rid)
                self._adapter_release(req)
                self.queue.appendleft(req)
                _metric("serving_deferred_total",
                        reason="pool_exhausted").inc()
                return
            except _TRANSIENT_ERRORS:
                self.pool.release(req.rid)
                self._adapter_release(req)
                self.queue.appendleft(req)
                _metric("serving_deferred_total",
                        reason="admit_fault").inc()
                return
            if self._prefix is not None:
                if m_tok > 0:
                    self._m_pfx_hits.inc()
                    self._m_pfx_saved.inc(m_tok)
                    self._prefix_matched[req.rid] = m_tok
                    if self._rec.enabled:
                        self._rec.record("prefix_hit", rid=req.rid,
                                         tokens=m_tok,
                                         blocks=len(matched))
                else:
                    self._m_pfx_miss.inc()
            self.lanes[lane] = req
            self._lane_epoch[lane] += 1
            # prefill covers only the unmatched tail
            self._prefill_tasks[lane] = _PrefillTask(
                req, lane, self._chunk_plan(req.prompt.size, m_tok))
            if self._tracer.enabled:
                t0 = int(req.t_arrival * 1e9)
                self._tracer.add_span(
                    "request.queued", t0, time.perf_counter_ns() - t0,
                    trace_id=req.trace_id, tid=LANE_TID_BASE + lane,
                    tid_name=f"lane {lane}", args={"rid": req.rid})
            if self._rec.enabled:
                self._rec.record("admit", rid=req.rid, lane=lane,
                                 epoch=int(self._lane_epoch[lane]))

    def _chunk_plan(self, s, start=0):
        """(start, width) pieces covering tokens [start, s) of a prompt:
        full chunks, then a tail padded to the smallest chunk width that
        fits. A non-zero start is a prefix-cache hit."""
        pieces = []
        while s - start > self.chunk:
            pieces.append((start, self.chunk))
            start += self.chunk
        rem = s - start
        width = next(w for w in self._chunk_widths if w >= rem)
        pieces.append((start, width))
        return pieces

    def _run_prefill_tasks(self):
        """Advance every in-flight prefill by up to
        prefill_chunks_per_step chunks (all remaining chunks when no lane
        is decoding)."""
        if not self._prefill_tasks:
            return
        decode_busy = bool(self._decode_active())
        for lane in sorted(self._prefill_tasks):
            task = self._prefill_tasks.get(lane)
            if task is None:
                continue
            budget = (self.prefill_chunks_per_step if decode_busy
                      else len(task.pieces) - task.idx)
            try:
                with _span("serving.prefill", rid=task.req.rid,
                           prompt=int(task.req.prompt.size)):
                    for _ in range(max(1, budget)):
                        if self._prefill_one_chunk(task):
                            break
            except MemoryError:
                self._abort_prefill(task, "prefill_oom")
                return
            except _TRANSIENT_ERRORS:
                self._abort_prefill(task, "prefill_fault")
                return

    def _abort_prefill(self, task, reason):
        """A chunk failed: give back the blocks and the lane and requeue
        the request at the front for a fresh prefill."""
        self._vacate(task.lane)
        self.queue.appendleft(task.req)
        _metric("serving_deferred_total", reason=reason).inc()

    def _prefill_chunk(self, ids, start, last_idx, table_row, adapter_id=0):
        """The prefill program: one chunk forward over every layer,
        writing the chunk's K/V (encoded in the pool's format) into the
        pool, with the lane's adapter delta when a store is attached;
        returns the f32 logits of the chunk's position `last_idx`. ids
        (1, W)."""
        cfg, pool = self.cfg, self.pool
        quant = pool.fmt.quantized
        ad = self.adapters
        h = self.embed_w[ids]                                   # (1, W, H)
        for li, lp in enumerate(self.layers):
            lora = (None if ad is None else
                    (ad.A_q[li, adapter_id], ad.B_q[li, adapter_id],
                     ad.A_v[li, adapter_id], ad.B_v[li, adapter_id]))
            h, _ = _llama_layer_prefill_chunk(
                lp, h, pool.k[li], pool.v[li], table_row, start, cfg,
                fmt=pool.fmt if quant else None,
                kc_scale=pool.k_scale[li] if quant else None,
                vc_scale=pool.v_scale[li] if quant else None, lora=lora)
        return (_rms(h[0, last_idx], self.norm_w, cfg["eps"])
                @ self._out_w).float()

    def _prefill_one_chunk(self, task):
        """Run one chunk forward; on the final chunk, choose the first
        token, index the prompt's blocks and activate the lane. Returns
        True when the task is done."""
        req = task.req
        start, width = task.pieces[task.idx]
        s = req.prompt.size
        fault_point("serve.prefill_chunk", rid=req.rid, start=start)
        n_real = min(width, s - start)
        ids = np.zeros((1, width), np.int64)
        ids[0, :n_real] = req.prompt[start:start + n_real]
        table = np.full(self.max_blocks_per_seq, self.pool.scratch_block,
                        np.int64)
        t = self.pool.tables[req.rid]
        table[:len(t)] = t
        is_final = task.idx == len(task.pieces) - 1
        last_idx = (s - 1 - start) if is_final else 0
        key = f"prefill.b{width}"
        cold = key not in self.compile_reports
        args = (torch.from_numpy(ids).to(self.device), int(start),
                int(last_idx), torch.from_numpy(table).to(self.device),
                req.adapter_id)
        timed = not cold and self.device.type == "cuda"
        t0 = time.perf_counter()
        if cold:
            # the width's first chunk is priced, and its time not read
            logits, self.compile_reports[key] = price(
                self._prefill_chunk, *args, name=f"serving.{key}")
        else:
            if timed:
                span = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                span[0].record()
            logits = self._prefill_chunk(*args)
            if timed:
                span[1].record()
                self._prefill_spans.append((key, *span))
        host_logits = logits.cpu().numpy() if is_final else None
        dt = time.perf_counter() - t0
        self._m_prefill.observe(dt)
        self._m_chunks.inc()
        if self._phases.enabled:
            self._phases.mark("compile" if cold else "prefill.chunk",
                              tenant=req.tenant)
        if not cold and self.device.type != "cuda":
            self._cost_observe(key, dt)
        self._observe_prefill_spans()
        if self._tracer.enabled:
            self._tracer.add_span(
                "request.prefill.chunk", int(t0 * 1e9), int(dt * 1e9),
                trace_id=req.trace_id, tid=LANE_TID_BASE + task.lane,
                tid_name=f"lane {task.lane}",
                args={"rid": req.rid, "chunk": task.idx, "width": width})
        task.idx += 1
        if not is_final:
            return False
        # final chunk: first token on the host (once per request); the
        # lane becomes decode-active -> membership change
        first_tok = req.choose(host_logits.reshape(-1))
        lane = task.lane
        self._prefill_tasks.pop(lane, None)
        ttft = time.perf_counter() - req.t_arrival
        req.t_first = req.t_arrival + ttft
        self._m_ttft.observe(ttft, exemplar=req.trace_id)
        _metric("serving_tenant_ttft_seconds",
                tenant=req.tenant).observe(ttft)
        if self.adapters is not None:
            _metric("serving_adapter_ttft_seconds",
                    adapter=req.adapter or "base").observe(ttft)
        if self.scheduler is not None:
            self.scheduler.note_ttft(ttft)
        # index the full-prompt blocks for the next sharer; a failure
        # leaves them unindexed and never touches a stream
        if self._prefix is not None:
            try:
                fault_point("serve.prefix_match", rid=req.rid)
                for b in self._prefix.insert(req.prompt,
                                             self.pool.tables[req.rid]):
                    self.pool.pin(b)
                for b in self._prefix.trim():
                    self.pool.unpin(b)
                    self._m_pfx_evict.inc()
                self._m_pfx_shared.set(len(self._prefix))
            except _TRANSIENT_ERRORS:
                _metric("serving_runtime_degradations_total",
                        what="prefix_miss").inc()
                if self._rec.enabled:
                    self._rec.record("degrade", what="prefix_miss",
                                     rid=req.rid)
        self.lane_len[lane] = s
        self.lane_tok[lane] = first_tok
        self._dirty = True
        self._m_admitted.inc()
        self._emit(lane, first_tok)
        return True

    def _emit(self, lane, token):
        req = self.lanes[lane]
        req.generated.append(int(token))
        self._m_tokens.inc()
        if (req.eos_token_id is not None
                and int(token) == req.eos_token_id):
            self._retire_lane(lane, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._retire_lane(lane, "length")

    # --- fused decode: dispatch / overlap / drain -------------------------
    def _decode_phase(self):
        """Double-buffered fused decode: dispatch tile N+1, then read back
        and book-keep tile N while the device computes. Membership changes
        force a drain + lane-state upload."""
        if self.compat_step_loop:
            self._dirty = True      # pre-fused loop: re-upload every step
        # the degradation sites fire BEFORE the drain/upload decision, so
        # an in-flight tile drains under the program it ran with before
        # the upload switches programs
        if self.spec:
            try:
                fault_point("serve.draft_verify", depth=self.draft_depth)
            except _TRANSIENT_ERRORS:
                self._disable_spec("draft_verify_fault")
        if self.pool.fmt.quantized:
            try:
                fault_point("serve.kv_dequant", fmt=self.pool.fmt.name)
            except _TRANSIENT_ERRORS:
                self._degrade_kv_to_bf16()
        active = self._decode_active()
        if not active:
            if self._inflight:
                self._drain_all()
            return
        if self._inflight and (self._dirty
                               or self._inflight[-1].covers_all
                               or len(self._inflight) >= 2):
            if not self._drain_all():
                return                 # transient host-sync fault: retry
            active = self._decode_active()
            if not active:
                return
        if self._dirty or self._variant is None:
            self._upload_lane_state(active)
            self._phases.mark("lane_upload")
        try:
            fault_point("serve.decode_oom", active=len(active))
            with _span("serving.decode_step", active=len(active),
                       k=self.decode_steps):
                tile, event, spec, cost_key, t0, span = self._dispatch()
        except MemoryError:
            # device OOM (or the serve.decode_oom fault site): shed one
            # lane and requeue it rather than killing every request
            self._shed(active)
            return
        except Exception as e:  # noqa: BLE001 - a device OOM is typed
            if _is_oom(e):
                self._shed(active)
                return
            raise
        self._m_dispatches.inc()
        self._m_ahead.set(len(self._inflight))
        K = self.decode_steps
        prev_reqs = self._inflight[-1].reqs if self._inflight else None
        covers_all = all(
            (self.lanes[i].max_new_tokens - len(self.lanes[i].generated)
             - (K if prev_reqs is not None and prev_reqs[i]
                is self.lanes[i] else 0)) <= K
            for i in active)
        # snapshot only decode-active lanes: a prefilling lane was dead on
        # the device and its tile row is filler
        active_set = set(active)
        snap = [self.lanes[i] if i in active_set else None
                for i in range(self.max_batch)]
        tile_id = self._tile_seq
        self._tile_seq += 1
        self._inflight.append(_Inflight(
            tile, event, t0, snap, self._lane_epoch.copy(), K, covers_all,
            tile_id, spec=spec, key=cost_key, span=span))
        if self._rec.enabled:
            self._rec.record("dispatch", tile=tile_id, lanes=list(active),
                             epochs=[int(self._lane_epoch[i])
                                     for i in active], k=K)
        # overlapped host bookkeeping: process the PREVIOUS tile while the
        # device runs this one (the compat loop drains its own tile too)
        keep = 0 if self.compat_step_loop else 1
        while len(self._inflight) > keep:
            if not self._drain_one():
                break

    def _disable_spec(self, why):
        """serve.draft_verify degradation: fall back to the plain fused
        decode for the engine's lifetime (a later brownout recovery cannot
        turn a faulted drafter back on). Streams continue unchanged; only
        the tokens per dispatch drop. _decode_phase drains in-flight tiles
        (flagged spec per tile) before honouring _dirty."""
        self.spec = False
        self._spec_allowed = False
        _metric("serving_runtime_degradations_total",
                what="speculation_off").inc()
        if self._rec.enabled:
            self._rec.record("degrade", what="speculation_off", why=why)
        self._dirty = True

    def _degrade_kv_to_bf16(self):
        """serve.kv_dequant degradation: dequantize the whole pool into a
        new pool of the native dtype, layer by layer (both pools are
        resident while it converts), and drop the quantized format for the
        engine's lifetime. Every captured graph read the old pool's
        tensors, so all are dropped once the stream is idle, and the next
        dispatch captures again. The lane state is untouched: decode goes
        on where the last dispatched tile left it."""
        t0 = time.perf_counter()
        pool, fmt = self.pool, self.pool.fmt
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._graphs.clear()
        self._graph_pool = None
        for name, scale in (("k", pool.k_scale), ("v", pool.v_scale)):
            old = getattr(pool, name)
            new = torch.empty(old.shape, dtype=fmt.native_dtype,
                              device=old.device)
            for li in range(old.shape[0]):
                new[li] = fmt.decode(old[li], scale[li])
            setattr(pool, name, new)
            del old
        pool.k_scale = pool.v_scale = None
        pool.fmt = KVBlockFormat("native", native_dtype=self.embed_w.dtype)
        # the index promised the old byte layout: drop every entry (the
        # blocks free once no resident request still holds them)
        if self._prefix is not None:
            for b in self._prefix.clear():
                self.pool.unpin(b)
                self._m_pfx_evict.inc()
            self._m_pfx_shared.set(0)
        _metric("serving_kv_dequant_seconds").observe(
            time.perf_counter() - t0)
        _metric("serving_runtime_degradations_total", what="kv_bf16").inc()
        if self._rec.enabled:
            self._rec.record("degrade", what="kv_bf16", fmt=fmt.name)

    # --- brownout knobs ---------------------------------------------------
    # The ladder's setters are REVERSIBLE, unlike the fault degradations
    # above: they flip the knob and mark the lane state dirty. The
    # membership machinery drains any in-flight tile under its dispatch-
    # time program before the next dispatch replays (or captures) the
    # program of the new (sampled, K, depth) key, so a mid-flight knob
    # change never double-emits or drops a token.
    def _set_decode_steps(self, k):
        k = 1 if self.compat_step_loop else max(1, int(k))
        if k == self.decode_steps:
            return
        self.decode_steps = k
        self._dirty = True

    def _set_draft_depth(self, d):
        d = max(1, min(int(d), self.pool.block_size - 1))
        if d == self.draft_depth:
            return
        self.draft_depth = d
        self._dirty = True

    def _set_speculation(self, on):
        want = bool(on) and self._spec_allowed \
            and not self.compat_step_loop
        if want == self.spec:
            return
        self.spec = want
        self._dirty = True

    def _set_prefill_chunk_small(self, on):
        # force_small_prefill_chunk rung: future admissions plan their
        # prefill at the smallest chunk width; plans already issued stay
        self.chunk = self._chunk_widths[0] if on else self._base_chunk

    def _set_mnt_cap(self, cap):
        # cap_max_new_tokens rung: requests admitted while engaged are
        # clamped to `cap` generated tokens; None restores uncapped
        self._mnt_cap = None if cap is None else max(1, int(cap))

    def _program(self, sampled, K, D):
        """The decode program of key (sampled, K, D) as a callable: the
        plain fused decode for D == 0, else the speculative one at draft
        depth D."""
        if D == 0:
            return lambda: self._decode_tile(sampled, K)
        return lambda: self._decode_tile_spec(sampled, K, D)

    def _dispatch(self):
        """Enqueue one decode tile over the uploaded lane state: on CUDA a
        replay of the (sampled, K, D) graph, captured on first use, then
        one non-blocking copy of its output to pinned host memory under
        an event; on the CPU an eager run. Returns (tile, event or None,
        whether the tile is speculative, the compile_reports key to
        observe or None for a cold dispatch, and the host time the
        dispatch began: on the CPU after the run that priced it, and the
        CUDA events around the replay or None). Every K and draft depth of
        one family shares a compile_reports key, priced once."""
        t0 = time.perf_counter()
        spec = self._variant.endswith(".spec")
        sampled = self._variant.startswith("sampled")
        K = self.decode_steps
        key = (sampled, K, self.draft_depth if spec else 0)
        self.program_keys_used.add(key)
        cost_key = ("decode" + (".sampled" if sampled else "")
                    + (".spec" if spec else ""))
        unpriced = cost_key not in self.compile_reports
        if self.device.type != "cuda":
            if unpriced:
                # priced in a run of its own with every lane dead, as the
                # card prices it in the capture's warm-up
                self._dead_run(self._program(*key), cost_key)
                self._phases.mark("compile")
                t0 = time.perf_counter()
            tile = self._program(*key)()
            self._phases.mark("decode.dispatch")
            return tile, None, spec, cost_key, t0, None
        prog = self._graphs.get(key)
        cold = prog is None
        if cold:
            prog = self._capture(*key, cost_key=cost_key if unpriced
                                 else None)
            self._graphs[key] = prog
            self.graph_captures += 1
            _metric("jit_retrace_total").inc()
        span = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[0].record()
        prog.graph.replay()
        span[1].record()
        host = torch.empty(prog.tile.shape, dtype=prog.tile.dtype,
                           pin_memory=True)
        host.copy_(prog.tile, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._phases.mark("compile" if cold else "decode.dispatch")
        return host, event, spec, None if cold else cost_key, t0, span

    def _dead_run(self, fn, cost_key=None):
        """Run a decode program once with every lane dead: it writes only
        the scratch block and the history's scratch column, and the lane
        state is left as it was. With a `cost_key`, the run prices the
        program into compile_reports. Returns its output."""
        alive = self._dev["alive"]
        saved = alive.clone()
        alive.zero_()
        try:
            if cost_key is None:
                return fn()
            out, self.compile_reports[cost_key] = price(
                fn, name=f"serving.{cost_key}")
            return out
        finally:
            alive.copy_(saved)

    def _capture(self, sampled, K, D=0, cost_key=None):
        """Capture the decode program of key (sampled, K, D) as a CUDA
        graph. The warm-up run that capture needs is a dead-lane run
        (`_dead_run`), which also prices the program when a `cost_key` is
        given. A failure raises: the engine never decodes eagerly on the
        card."""
        fn = self._program(sampled, K, D)
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                warm = self._dead_run(fn, cost_key)
            torch.cuda.current_stream(self.device).wait_stream(side)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            tile = torch.zeros_like(warm)
            del warm
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._graph_pool):
                tile.copy_(fn())
        except Exception as e:
            raise RuntimeError(
                f"capturing the decode program (sampled={sampled}, K={K}, "
                f"draft depth={D}) as a CUDA graph failed: {e}") from e
        return _DecodeGraph(graph, tile)

    def _pool_layer(self, li):
        """(format or None, k, v, k_scale, v_scale) of one layer's pool."""
        pool = self.pool
        if pool.fmt.quantized:
            return (pool.fmt, pool.k[li], pool.v[li], pool.k_scale[li],
                    pool.v_scale[li])
        return None, pool.k[li], pool.v[li], None, None

    def _qkv(self, li, lp, h, pos, aids):
        """One token per lane into attention: h [B, 1, H] at positions pos
        [B, 1] -> rotated q [B, nh, hd], rotated k and v [B, nkv, hd], with
        each lane's LoRA delta on q and v when a store is attached (slot 0
        adds exactly zero). The plain and the speculative decode both go
        through here, so each verified position repeats the plain step's
        operations exactly."""
        cfg = self.cfg
        nh, nkv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
        B = h.shape[0]
        x = _rms(h, lp["input_layernorm.weight"], cfg["eps"])
        q = x @ lp["self_attn.q_proj.weight"]
        v = x @ lp["self_attn.v_proj.weight"]
        if aids is not None:
            ad = self.adapters
            q = q + _lora_delta(x, ad.A_q[li], ad.B_q[li], aids)
            v = v + _lora_delta(x, ad.A_v[li], ad.B_v[li], aids)
        k = (x @ lp["self_attn.k_proj.weight"]).reshape(B, 1, nkv, hd)
        q = _rope(q.reshape(B, 1, nh, hd), pos, cfg["theta"])[:, 0]
        k = _rope(k, pos, cfg["theta"])[:, 0]
        return q, k, v.reshape(B, nkv, hd)

    def _attn_out(self, lp, h, attn):
        """The rest of a layer after attention: o_proj, residual, MLP."""
        B = h.shape[0]
        h = h + (attn.reshape(B, 1, -1) @ lp["self_attn.o_proj.weight"])
        return _mlp(lp, h, self.cfg["eps"])

    def _logits(self, h):
        """f32 logits [B, V] of h [B, 1, H]."""
        return (_rms(h[:, 0], self.norm_w, self.cfg["eps"])
                @ self._out_w).float()

    def _choose(self, logits, lens, sampled):
        """Each lane's token for the position after `lens`: the argmax, or
        the lane's (seed, position) draw for sampled lanes."""
        nxt = torch.argmax(logits, dim=-1)
        if sampled:
            d = self._dev
            samp = _device_sample(logits, d["seeds"], lens, d["temp"],
                                  d["top_k"], d["top_p"])
            nxt = torch.where(d["do_sample"], samp, nxt)
        return nxt

    def _decode_tile(self, sampled, K):
        """The fused decode program: K steps of every lane over the static
        lane state and the pool, both updated in place. Returns the [B, K]
        int64 token tile. Dead lanes write their K/V to the scratch block
        and re-emit their last token (never credited: the host walk stops
        at the same eos/length boundary)."""
        d, cfg = self._dev, self.cfg
        scale = 1.0 / (cfg["head_dim"] ** 0.5)
        scratch = self.pool.scratch_block
        toks, lens, alive, rem = d["toks"], d["lens"], d["alive"], d["rem"]
        tables = d["tables"]
        aids = d.get("adapter_ids")
        out = []
        for _ in range(K):
            h = self.embed_w[toks][:, None]                     # (B, 1, H)
            pos = lens[:, None]                                 # write pos
            for li, lp in enumerate(self.layers):
                fmt, kc, vc, ksc, vsc = self._pool_layer(li)
                q, k, v = self._qkv(li, lp, h, pos, aids)
                kv_write_token(fmt, kc, vc, ksc, vsc, k, v, tables, lens,
                               active=alive, scratch_block=scratch)
                attn = paged_attention_decode_inner(
                    q, kc, vc, tables, lens + 1, scale=scale, fmt=fmt,
                    k_scale_cache=ksc, v_scale_cache=vsc)
                h = self._attn_out(lp, h, attn)
            nxt = self._choose(self._logits(h), lens, sampled)
            nxt = torch.where(alive, nxt, toks)
            rem = rem - alive.long()
            lens = lens + alive.long()
            alive = alive & (nxt != d["eos"]) & (rem > 0)
            toks = nxt
            out.append(nxt)
        d["toks"].copy_(toks)
        d["lens"].copy_(lens)
        d["alive"].copy_(alive)
        d["rem"].copy_(rem)
        return torch.stack(out, dim=1)

    def _decode_tile_spec(self, sampled, K, D):
        """The speculative decode program (reference `_make_decode_spec`):
        each of K steps records the step token into the lane's history,
        drafts D tokens, writes the K/V of the step token and the drafts
        (C = D + 1 positions per lane), verifies them, accepts the leading
        run of drafts that equal what the plain decode would emit, rolls
        back the rejected positions' writes byte for byte, and commits the
        accepted run plus one correction token.

        Position i of a step goes through the plain decode step's own
        operations (`_qkv`, paged_attention_verify's per-query decode
        attention over pages gathered once per layer, `_attn_out`,
        `_logits`, `_choose` at position lens + i), so the token it yields
        is the plain decode's bit for bit and the committed stream cannot
        change. Acceptance, the EOS clip and the rollback mask stay
        tensors: no host sync. Returns the [B, K, C + 1] int64 tile: each
        step's C tokens, then its commit count (0 once the lane died)."""
        d, cfg = self._dev, self.cfg
        scale = 1.0 / (cfg["head_dim"] ** 0.5)
        scratch = self.pool.scratch_block
        C = D + 1
        toks, lens, alive, rem = d["toks"], d["lens"], d["alive"], d["rem"]
        tables, hist, eos = d["tables"], d["hist"], d["eos"]
        aids = d.get("adapter_ids")
        hmax = hist.shape[1] - 1             # the last column is scratch
        B = toks.shape[0]
        rows = torch.arange(B, device=toks.device)
        steps = torch.arange(C, device=toks.device)
        out = []
        for _ in range(K):
            # the step token at lens; dead lanes write the scratch column
            hist[rows, torch.where(alive, lens, hmax)] = toks
            if self._drafter is not None:
                drafts = self._drafter(hist[:, :hmax], lens, toks, D).long()
            else:
                drafts = _ngram_draft(hist[:, :hmax], lens, toks, D,
                                      self.draft_ngram)
            didx = torch.where(alive[:, None], lens[:, None] + 1
                               + steps[None, :D], hmax).clamp(max=hmax)
            hist[rows[:, None], didx] = drafts
            u = torch.cat([toks[:, None], drafts], dim=1)       # (B, C)
            hs = [self.embed_w[u[:, i]][:, None] for i in range(C)]
            pos = [(lens + i)[:, None] for i in range(C)]
            saved = []
            for li, lp in enumerate(self.layers):
                fmt, kc, vc, ksc, vsc = self._pool_layer(li)
                qkv = [self._qkv(li, lp, hs[i], pos[i], aids)
                       for i in range(C)]
                q, k, v = (torch.stack(t, dim=1) for t in zip(*qkv))
                *_, sv = kv_write_tokens(fmt, kc, vc, ksc, vsc, k, v,
                                         tables, lens, active=alive,
                                         scratch_block=scratch)
                saved.append(sv)
                attn = paged_attention_verify(
                    q, kc, vc, tables, lens, scale=scale, fmt=fmt,
                    k_scale_cache=ksc, v_scale_cache=vsc)
                hs = [self._attn_out(lp, hs[i], attn[:, i])
                      for i in range(C)]
            # g[:, i]: the token the plain decode emits at position
            # lens + i + 1 given that the drafts before i were right
            g = torch.stack([self._choose(self._logits(hs[i]), lens + i,
                                          sampled)
                             for i in range(C)], dim=1)         # (B, C)
            n_acc = torch.cumprod((drafts == g[:, :D]).long(),
                                  dim=1).sum(dim=1)
            commits = torch.minimum(n_acc + 1, rem)
            iseos = g == eos[:, None]
            eos_clip = torch.where(iseos.any(dim=1),
                                   iseos.long().argmax(dim=1) + 1, C)
            commits = torch.minimum(commits, eos_clip)
            commits = torch.where(alive, commits, 0)
            keep = (steps[None, :] < commits[:, None]) & alive[:, None]
            for li, sv in enumerate(saved):
                fmt, kc, vc, ksc, vsc = self._pool_layer(li)
                kv_rollback_tokens(fmt, kc, vc, ksc, vsc, sv, tables, lens,
                                   keep, active=alive, scratch_block=scratch)
            last = (commits - 1).clamp(0, C - 1)
            g_last = g.gather(1, last[:, None])[:, 0]
            ended_eos = alive & (commits > 0) & (g_last == eos)
            toks = torch.where(alive, g_last, toks)
            rem = rem - commits
            lens = lens + commits
            alive = alive & ~ended_eos & (rem > 0)
            out.append(torch.cat([g, commits[:, None]], dim=1))
        d["toks"].copy_(toks)
        d["lens"].copy_(lens)
        d["alive"].copy_(alive)
        d["rem"].copy_(rem)
        return torch.stack(out, dim=1)

    def _drain_all(self):
        while self._inflight:
            if not self._drain_one():
                return False
        return True

    def _drain_one(self):
        """Read back the oldest in-flight tile and run host bookkeeping.
        Returns False on a transient host-sync fault (tile kept, retried
        next step)."""
        infl = self._inflight[0]
        try:
            fault_point("serve.hostsync_read")
            t0 = time.perf_counter()
            self._phases.mark("decode.readback")
            if infl.event is not None:
                infl.event.synchronize()
            arr = infl.tile.numpy()
        except MemoryError:
            self._inflight.popleft()
            self._shed(self._decode_active())
            return True
        except _TRANSIENT_ERRORS:
            self._m_hostsync_retries.inc()
            return False
        except Exception as e:  # noqa: BLE001 - a device OOM is typed
            if _is_oom(e):
                self._inflight.popleft()
                self._shed(self._decode_active())
                return True
            raise
        t1 = time.perf_counter()
        self._inflight.popleft()
        self._m_hostsync.observe(t1 - t0)
        self._phases.mark("hostsync")
        if infl.key is not None:
            self._cost_observe(infl.key, t1 - infl.t_dispatch
                               if infl.span is None else
                               infl.span[0].elapsed_time(infl.span[1]) / 1e3)
        self._observe_prefill_spans()
        # one dispatch advances every active lane K tokens, so the
        # dispatch->readback wall over K is the per-token latency; the
        # first live lane's trace id stands for the tile
        ex = None
        if self._reg.enabled:
            for r in infl.reqs:
                if r is not None and not r.done:
                    ex = r.trace_id
                    break
        if not infl.spec:
            self._observe_tpot(infl, (t1 - infl.t_dispatch) / infl.k, ex)
        if self._rec.enabled:
            self._rec.record("readback", tile=infl.tile_id,
                             wait_ms=round((t1 - t0) * 1e3, 3))
        if self._tracer.enabled:
            self._trace_tile(infl, t1)
        if infl.spec:
            self._process_tile_spec(arr[..., :-1], arr[..., -1], infl, t1,
                                    ex)
        else:
            self._process_tile(arr, infl)
        ph = self._phases
        if ph.enabled:
            ph.mark("commit")
            tenants = sorted({r.tenant for r in infl.reqs if r is not None})
            ph.credit_tenants(tenants, t1 - infl.t_dispatch)
        return True

    def _observe_tpot(self, infl, per_tok, ex):
        """A drained tile's per-token latency into the TPOT histograms
        (overall, per tenant and per adapter) and the scheduler."""
        self._m_tpot.observe(per_tok, exemplar=ex)
        if self.scheduler is not None:
            self.scheduler.note_tpot(per_tok)
        live = [r for r in infl.reqs if r is not None and not r.done]
        for t in sorted({r.tenant for r in live}):
            _metric("serving_tenant_tpot_seconds",
                    tenant=t).observe(per_tok)
        if self.adapters is not None:
            for a in sorted({r.adapter or "base" for r in live}):
                _metric("serving_adapter_tpot_seconds",
                        adapter=a).observe(per_tok)

    def _live(self, infl, lane):
        """Whether a tile's row `lane` still belongs to the request it was
        dispatched for."""
        req = infl.reqs[lane]
        return not (req is None or req.done
                    or self.lanes[lane] is not req
                    or self._lane_epoch[lane] != infl.epochs[lane])

    def _trace_tile(self, infl, t1):
        """Span-link a drained tile: one serving.decode_tile span linking
        every request it advanced, plus a request.decode.tile span in each
        lane's trace group."""
        t0_ns = int(infl.t_dispatch * 1e9)
        dur_ns = int((t1 - infl.t_dispatch) * 1e9)
        links = []
        for lane, req in enumerate(infl.reqs):
            if not self._live(infl, lane):
                continue
            links.append(req.trace_id)
            self._tracer.add_span(
                "request.decode.tile", t0_ns, dur_ns,
                trace_id=req.trace_id, tid=LANE_TID_BASE + lane,
                tid_name=f"lane {lane}",
                args={"rid": req.rid, "tile": infl.tile_id, "k": infl.k})
        self._tracer.add_span(
            "serving.decode_tile", t0_ns, dur_ns,
            args={"tile": infl.tile_id, "k": infl.k},
            links=links or None)

    def _process_tile(self, tile, infl):
        """Credit a [B, K] token tile: walk each lane's K tokens with the
        SAME eos/length rules the device applied, so the host mirrors and
        the device state stay in step without reading lens/alive back."""
        credited = 0
        for lane in range(self.max_batch):
            if not self._live(infl, lane):
                continue            # occupancy changed while in flight
            req = infl.reqs[lane]
            for k in range(infl.k):
                self.lane_len[lane] += 1
                tok = int(tile[lane, k])
                self.lane_tok[lane] = tok
                credited += 1
                self._emit(lane, tok)
                if req.done or self.lanes[lane] is not req:
                    break
        self._m_tok_disp.set(credited)

    def _process_tile_spec(self, tile, counts, infl, t1, ex):
        """Credit a speculative tile: tokens [B, K, D + 1] and counts
        [B, K]. Step k of a lane commits its first counts[lane, k] tokens
        (the accepted drafts and one correction token); counts drop to 0
        once the lane died on the device. The host walk applies the
        device's eos/length rules; the draft and accept counts and the
        acceptance rate (exemplar: the worst-accepting request) are
        credited once per drained tile."""
        D = tile.shape[2] - 1
        credited = 0
        lanes_credited = 0
        drafted = accepted = 0
        worst = None
        for lane in range(self.max_batch):
            if not self._live(infl, lane):
                continue            # occupancy changed while in flight
            req = infl.reqs[lane]
            lanes_credited += 1
            lane_drafted = lane_accepted = 0
            for k in range(infl.k):
                c = int(counts[lane, k])
                if c <= 0:
                    break
                lane_drafted += D
                lane_accepted += c - 1
                for i in range(c):
                    self.lane_len[lane] += 1
                    tok = int(tile[lane, k, i])
                    self.lane_tok[lane] = tok
                    credited += 1
                    self._emit(lane, tok)
                    if req.done or self.lanes[lane] is not req:
                        break
                if req.done or self.lanes[lane] is not req:
                    break
            drafted += lane_drafted
            accepted += lane_accepted
            if lane_drafted:
                rate = lane_accepted / lane_drafted
                if worst is None or rate < worst[0]:
                    worst = (rate, req.trace_id)
        if drafted:
            self._m_draft.inc(drafted)
            self._m_accept.inc(accepted)
            self._m_accept_rate.observe(
                accepted / drafted, exemplar=worst[1] if worst else None)
        self._m_tok_disp.set(credited)
        # per-token latency over the tokens one lane actually committed
        eff = credited / max(1, lanes_credited)
        self._observe_tpot(infl, (t1 - infl.t_dispatch) / max(1.0, eff), ex)

    # --- device-resident lane state ---------------------------------------
    def _upload_lane_state(self, active):
        """Refill the device lane state from the host mirrors, in place —
        called only on membership change (admission / retire / shed /
        preempt / resume / a knob change), never in the steady state."""
        B, MB = self.max_batch, self.max_blocks_per_seq
        tables = np.full((B, MB), self.pool.scratch_block, np.int64)
        lens = np.zeros(B, np.int64)
        toks = np.zeros(B, np.int64)
        alive = np.zeros(B, bool)
        rem = np.zeros(B, np.int64)
        eos = np.full(B, -1, np.int64)
        seeds = np.zeros(B, np.int64)
        do_s = np.zeros(B, bool)
        temp = np.ones(B, np.float32)
        top_k = np.zeros(B, np.int64)
        top_p = np.ones(B, np.float32)
        aids = np.zeros(B, np.int64)
        sampled = any(self.lanes[i].do_sample for i in active)
        for i in active:
            r = self.lanes[i]
            t = self.pool.tables[r.rid]
            tables[i, :len(t)] = t
            lens[i] = self.lane_len[i]
            toks[i] = self.lane_tok[i]
            alive[i] = True
            rem[i] = r.max_new_tokens - len(r.generated)
            aids[i] = r.adapter_id
            if r.eos_token_id is not None:
                eos[i] = r.eos_token_id
            if r.do_sample:
                do_s[i] = True
                seeds[i] = int(r.sample_seed)
                temp[i] = max(r.temperature, 1e-6)
                top_k[i] = r.top_k
                top_p[i] = r.top_p
        host = dict(tables=tables, lens=lens, toks=toks, alive=alive,
                    rem=rem, eos=eos, seeds=seeds, do_sample=do_s,
                    temp=temp, top_k=top_k, top_p=top_p)
        if self.adapters is not None:
            # slot 0 (the all-zeros base) for empty lanes and base requests
            host["adapter_ids"] = aids
        if self.spec:
            # each lane's prompt and committed tokens up to its cached
            # length: the drafter's corpus, extended on the device
            hist = np.zeros(self._dev["hist"].shape, np.int64)
            hmax = hist.shape[1] - 1
            for i in active:
                r = self.lanes[i]
                seq = (np.concatenate([r.prompt, np.asarray(
                    r.generated[:-1], np.int32)]) if r.generated
                    else r.prompt)
                n = min(seq.size, hmax)
                hist[i, :n] = seq[:n]
            host["hist"] = hist
        for name, arr in host.items():
            self._dev[name].copy_(torch.from_numpy(arr))
        self._variant = (("sampled" if sampled else "greedy")
                         + (".spec" if self.spec else ""))
        self._dirty = False
        self._m_uploads.inc()
        if self._rec.enabled:
            self._rec.record("membership", active=list(active),
                             variant=self._variant)


def _lora_delta(x, a_pool, b_pool, aids):
    """Each lane's low-rank delta x @ A[aid] @ B[aid]: x [B, c, H], the
    layer's factor pools [n_slots, H, r] and [n_slots, r, D], aids [B] slot
    ids. Slot 0 holds zeros, so a base lane adds exactly 0."""
    a = a_pool[aids].to(x.dtype)                            # (B, H, r)
    b = b_pool[aids].to(x.dtype)                            # (B, r, D)
    return torch.bmm(torch.bmm(x, a), b)


def _ngram_draft(hist, lens, toks, depth, ngram):
    """The built-in drafter, prompt-lookup decoding (reference :2487): per
    lane, the `depth` tokens that followed the most recent earlier
    occurrence of the trailing `ngram`-token suffix of the history (the
    step token at hist[b, lens[b]]); lanes with no match propose the step
    token `depth` times. Batched index arithmetic over the device-resident
    history, so it runs inside the captured decode graph."""
    return _lookup(hist, lens, toks, depth, ngram)[0]


def _is_oom(e):
    """A device out-of-memory error, whatever its type."""
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(e).lower()
            or "RESOURCE_EXHAUSTED" in str(e))


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash of int64 tensors holding values in
    [0, 2^32): xorshift-multiply rounds whose multipliers stay below 2^31,
    so every product fits in int64 without overflow."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _uniform(seeds, lens, vocab):
    """[B, V] f32 uniforms in (0, 1), a pure function of (lane seed,
    absolute position, token id): a counter-based draw, so a lane's stream
    does not depend on how the decode steps are tiled."""
    key = _mix32(_mix32(seeds) ^ _mix32(lens + 0x632BE5AB))       # [B]
    ids = torch.arange(vocab, device=seeds.device)
    bits = _mix32(key[:, None] ^ _mix32(ids + 0x1B873593)[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _device_sample(logits, seeds, lens, temperature, top_k, top_p):
    """Per-lane sampling on the device: temperature -> top-k -> nucleus ->
    categorical, vectorized over lanes (reference :2514). The categorical
    draw is Gumbel-max over a counter-based hash of (lane seed, absolute
    position), so a lane's stream is a pure function of (seed, position):
    the same for decode_steps 1 and K, and capturable in a CUDA graph.
    torch's stateful generators could not be, and could not reproduce
    JAX's keys anyway: sampled streams are held to themselves."""
    B, V = logits.shape
    z = logits / torch.clamp(temperature, min=1e-6)[:, None]
    svals = torch.sort(z, dim=-1, descending=True, stable=True).values
    idx = torch.clamp(top_k - 1, 0, V - 1)
    kth = torch.gather(svals, -1, idx[:, None])
    z = torch.where((top_k > 0)[:, None] & (z < kth), -torch.inf, z)
    probs = torch.softmax(z, dim=-1)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sp, dim=-1)
    keep_sorted = (cum - sp) < top_p[:, None]
    keep_sorted[:, 0] = True            # top_p=0 keeps the argmax
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    z = torch.where((top_p < 1.0)[:, None] & ~keep, -torch.inf, z)
    gumbel = -torch.log(-torch.log(_uniform(seeds, lens, V)))
    return torch.argmax(z + gumbel, dim=-1)

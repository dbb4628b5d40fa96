"""Continuous-batching serving engine over the paged KV cache.

reference: paddle_tpu/inference/serving.py — `Request` (:90),
`_LayeredBlockPool` (:174), `_PrefillTask`, `_Inflight`,
`ContinuousBatchingEngine` (:343) with its chunked prefill (:1324-1508),
its fused K-step decode (`_make_decode`, :2161) and `_device_sample`
(:2514).

Two programs serve every request mix:

  - chunked prefill: a prompt is split into fixed-width chunks; each chunk
    forward writes its K/V into the paged pool and attends over every
    earlier position (`generation._llama_layer_prefill_chunk`), so a long
    prompt interleaves with decode tiles. It runs eagerly.
  - fused K-step decode: one program advances every lane `decode_steps`
    tokens: greedy argmax, per-lane sampling for sampled lanes, the paged
    writes and the EOS/length masking all on the device, returning a
    [B, K] token tile. On CUDA each (sampled, K) program is captured once
    as a `torch.cuda.CUDAGraph` over static lane-state and pool tensors
    and each dispatch is one replay; if a capture fails the engine raises
    and never decodes eagerly on the card. On the CPU, which has no
    graphs, the same function runs eagerly.

Lane state (block tables, lengths, next tokens, alive mask, sampling
knobs) is device-resident: `_upload_lane_state` fills the static tensors
in place only when lane membership changes
(`serving_lane_state_uploads_total`). Dispatch is double-buffered: tile
N+1 is enqueued before tile N is read back. Each replay is followed by a
non-blocking copy of its token tile to pinned host memory under a CUDA
event, which `_drain_one` waits on.

Memory is allocated in block_size granules from one (L, num_blocks, ...)
pool; the last block is the scratch target of dead lanes.

Not ported yet (ROADMAP.md Queue 1, slice 4, next step): speculative
decode, LoRA adapters, the SLO scheduler with preemption, the prefix
cache, quantized KV formats in the engine, and the mesh's export_kv /
import_kv. Asking for any of them raises NotImplementedError. The engine
has no PIR cost model either: `predicted_costs` and
`predicted_service_seconds` return None, as the reference's do before it
has calibrated.
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
from ..ops.paged_attention import (KVBlockFormat, kv_write_token,
                                   paged_attention_decode_inner)
from ..profiler.phases import get_phase_accountant as _get_phases
from ..resilience.faults import FaultInjected, fault_point

__all__ = ["ContinuousBatchingEngine", "Request", "BackpressureError",
           "KVPoolExhaustedError"]

# exception classes that mean "transient trouble, retry next step" when
# they surface from an admission / prefill-chunk / host-sync seam
_TRANSIENT_ERRORS = (TimeoutError, ConnectionError, OSError, FaultInjected)

# the request priority classes of the reference's scheduler.py (:55); the
# engine validates the name, and only a scheduler (not ported) reads it
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, slice 4, next step)")


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
                 "tenant", "priority", "t_first", "adapter")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=None, deadline_s=None, tenant="-",
                 priority="interactive", adapter=None):
        self.rid = rid
        # a named LoRA adapter; the port has no adapter store, so the
        # engine rejects such a request at admission, as the reference's
        # engine does without a store
        self.adapter = str(adapter) if adapter else None
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
    the scratch target of dead decode lanes. The reference's refcounted
    sharing (pin, adopt, fork_cow) waits for the prefix cache."""

    def __init__(self, num_layers, num_blocks, block_size, kv_heads,
                 head_dim, dtype, device, fmt=None):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.fmt = fmt if fmt is not None else KVBlockFormat(
            "native", native_dtype=dtype)
        shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.scratch_block = num_blocks - 1
        self._free = list(range(num_blocks - 2, -1, -1))
        self.tables: dict[int, list[int]] = {}

    def blocks_needed(self, n_tokens):
        return (n_tokens + self.block_size - 1) // self.block_size

    def can_fit(self, n_tokens, have=0):
        return len(self._free) >= self.blocks_needed(n_tokens) - have

    def ensure(self, rid, n_tokens):
        table = self.tables.setdefault(rid, [])
        need = self.blocks_needed(n_tokens)
        while len(table) < need:
            if not self._free:
                _metric("serving_pool_exhausted_total").inc()
                raise KVPoolExhaustedError("paged KV pool exhausted")
            table.append(self._free.pop())
        return table

    def release(self, rid):
        self._free.extend(self.tables.pop(rid, []))


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
    """One dispatched-but-unread decode tile: the [B, K] token tile (a
    pinned host tensor on CUDA, filled under `event`) plus the lane
    snapshot (request refs + lane epochs) that credits tokens only to
    lanes whose occupancy did not change while the tile was in flight."""

    __slots__ = ("tile", "event", "t_dispatch", "reqs", "epochs", "k",
                 "covers_all", "tile_id")

    def __init__(self, tile, event, t_dispatch, reqs, epochs, k, covers_all,
                 tile_id=0):
        self.tile = tile
        self.event = event
        self.t_dispatch = t_dispatch
        self.reqs = reqs
        self.epochs = epochs
        self.k = k
        self.covers_all = covers_all
        self.tile_id = tile_id


class _DecodeGraph:
    """One captured decode program: its graph and its static token tile."""

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
        lane state uploaded every step, every tile drained synchronously.
      kv_cache_dtype: "bf16"/"native" (the pool holds the model dtype).
      kv_pool_bytes: size the pool by a byte budget instead of num_blocks.
      max_queue / max_sheds: backpressure and shed limits.

    speculative_decode, adapters, scheduler, prefix_cache and a quantized
    kv_cache_dtype raise NotImplementedError (ROADMAP.md); draft_depth,
    draft_ngram, drafter and prefix_cache_blocks, which only those knobs
    read, are taken for the reference's signature and have no effect.
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
        if speculative_decode:
            raise _not_ported("speculative_decode=True")
        if adapters is not None:
            raise _not_ported("adapters=")
        if scheduler is not None:
            raise _not_ported("scheduler=")
        if prefix_cache:
            raise _not_ported("prefix_cache=True")
        if kv_cache_dtype not in ("bf16", "native"):
            raise _not_ported(f"kv_cache_dtype={kv_cache_dtype!r}")
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
        self._variant = None          # "greedy" | "sampled" once uploaded
        self._dirty = True
        self._inflight: deque[_Inflight] = deque()
        # (sampled, K) -> captured decode program (CUDA only); the graphs
        # share one memory pool, as they never run at once
        self._graphs: dict[tuple, _DecodeGraph] = {}
        self._graph_pool = None
        self.graph_captures = 0
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
        self._m_tok_disp = _metric("serving_tokens_per_dispatch")
        self._tracer = _get_tracer()
        self._reg = _get_registry()
        self._rec = _get_recorder()
        self._tile_seq = 0              # decode tile ids for span links
        self._phases = _get_phases()
        # bounded-cardinality tenant label set: past the cap new tenants
        # collapse to "overflow"
        self._tenants: set[str] = set()
        self._max_tenants = 32

    # --- public API -------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                    seed=0, deadline_s=None, tenant="-",
                    priority="interactive", adapter=None):
        """Queue a request; returns its id. `deadline_s` is a wall-clock
        budget from arrival: once exceeded the request finishes with what
        it has and finish_reason='timeout'. `tenant` labels its telemetry
        (bounded cardinality). `priority` must name a class of
        PRIORITY_CLASSES. A request naming an `adapter` is rejected at
        admission (no adapter store). Raises BackpressureError when the
        admission queue is at max_queue."""
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
        if self._tracer.enabled:
            self._tracer.add_span("request.admit",
                                  int(req.t_arrival * 1e9), 0,
                                  trace_id=req.trace_id, args={"rid": rid})
        return rid

    def has_work(self):
        return (bool(self.queue) or any(r is not None for r in self.lanes)
                or bool(self._inflight))

    def run(self, max_steps=10_000):
        """Drive to completion; returns {rid: [generated tokens]}."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return {rid: r.generated for rid, r in self.finished.items()}

    def export_kv(self, req, first_tok):
        raise _not_ported("export_kv (the serving mesh)")

    def import_kv(self, record):
        raise _not_ported("import_kv (the serving mesh)")

    def predicted_costs(self):
        """None: the engine has no PIR cost model yet (ROADMAP.md slice
        6), as the reference returns no calibrated cost before its first
        measured dispatch."""
        return None

    def predicted_service_seconds(self, output_tokens=32):
        """None until a cost model is ported; callers fall back to
        measured throughput."""
        return None

    # --- scheduling -------------------------------------------------------
    @torch.no_grad()
    def step(self):
        ph = self._phases
        ph.begin_step()
        with _span("serving.step"):
            self._expire_deadlines()
            self._m_queue.set(len(self.queue))
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

    def _vacate(self, lane):
        """Empty a lane: its prefill task, its blocks and its slot."""
        req = self.lanes[lane]
        self._prefill_tasks.pop(lane, None)
        self.pool.release(req.rid)
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
        """An expired queued request finishes empty; an expired decoding
        (or prefilling) lane finishes with the tokens it has and releases
        its blocks."""
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

    def cancel(self, rid):
        """Withdraw one request wherever it lives (queued or in a lane)
        without a finished record; its blocks release. Returns whether
        anything was withdrawn."""
        rid = int(rid)
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                break
        else:
            lane = next((i for i, r in enumerate(self.lanes)
                         if r is not None and r.rid == rid), None)
            if lane is None:
                return False
            self._vacate(lane)
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

    # --- admission / chunked prefill -------------------------------------
    def _admit(self):
        """FIFO admission: reserve a lane and the request's whole block
        footprint; the prompt prefills chunk by chunk in
        _run_prefill_tasks."""
        while self.queue:
            free_lanes = [i for i, r in enumerate(self.lanes) if r is None]
            if not free_lanes:
                return
            req = self.queue[0]
            total = req.prompt.size + req.max_new_tokens
            if total > self.max_blocks_per_seq * self.pool.block_size:
                # cannot ever serve: rejected with an empty result
                self.queue.popleft()
                req.generated = []
                self._finish(req, "rejected")
                _metric("serving_rejected_total", reason="oversized").inc()
                continue
            if req.max_new_tokens <= 0:
                self.queue.popleft()
                self._finish(req, "length")
                continue
            # admit only if the WHOLE sequence fits: no mid-flight
            # eviction of live requests
            if not self.pool.can_fit(total):
                _metric("serving_deferred_total", reason="pool_full").inc()
                return
            self.queue.popleft()
            if req.adapter:
                # no adapter store: a typed rejection, never a base-weights
                # stream under an adapter's name
                try:
                    fault_point("serve.adapter_load", rid=req.rid,
                                adapter=req.adapter)
                except _TRANSIENT_ERRORS:
                    pass
                req.generated = []
                self._finish(req, "rejected")
                _metric("serving_rejected_total", reason="adapter").inc()
                _metric("serving_adapter_load_failures_total").inc()
                if self._rec.enabled:
                    self._rec.record("adapter", action="reject",
                                     rid=req.rid, adapter=req.adapter)
                continue
            lane = free_lanes[0]
            try:
                fault_point("serve.admit", rid=req.rid)
                # reserve the FULL footprint now, so decode never exhausts
                # the pool mid-flight
                self.pool.ensure(req.rid, total)
            except MemoryError:
                self.pool.release(req.rid)
                self.queue.appendleft(req)
                _metric("serving_deferred_total",
                        reason="pool_exhausted").inc()
                return
            except _TRANSIENT_ERRORS:
                self.pool.release(req.rid)
                self.queue.appendleft(req)
                _metric("serving_deferred_total",
                        reason="admit_fault").inc()
                return
            self.lanes[lane] = req
            self._lane_epoch[lane] += 1
            self._prefill_tasks[lane] = _PrefillTask(
                req, lane, self._chunk_plan(req.prompt.size))
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
        fits."""
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

    def _prefill_chunk(self, ids, start, last_idx, table_row):
        """The prefill program: one chunk forward over every layer,
        writing the chunk's K/V into the pool; returns the f32 logits of
        the chunk's position `last_idx`. ids (1, W)."""
        cfg = self.cfg
        h = self.embed_w[ids]                                   # (1, W, H)
        for li, lp in enumerate(self.layers):
            h, _ = _llama_layer_prefill_chunk(
                lp, h, self.pool.k[li], self.pool.v[li], table_row, start,
                cfg)
        return (_rms(h[0, last_idx], self.norm_w, cfg["eps"])
                @ self._out_w).float()

    def _prefill_one_chunk(self, task):
        """Run one chunk forward; on the final chunk, choose the first
        token and activate the lane. Returns True when the task is done."""
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
        t0 = time.perf_counter()
        logits = self._prefill_chunk(
            torch.from_numpy(ids).to(self.device), int(start), int(last_idx),
            torch.from_numpy(table).to(self.device))
        host_logits = logits.cpu().numpy() if is_final else None
        dt = time.perf_counter() - t0
        self._m_prefill.observe(dt)
        self._m_chunks.inc()
        if self._phases.enabled:
            self._phases.mark("prefill.chunk", tenant=req.tenant)
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
        t0 = time.perf_counter()
        try:
            fault_point("serve.decode_oom", active=len(active))
            with _span("serving.decode_step", active=len(active),
                       k=self.decode_steps):
                tile, event = self._dispatch()
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
            tile_id))
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

    def _dispatch(self):
        """Enqueue one decode tile over the uploaded lane state: on CUDA a
        replay of the (variant, K) graph, captured on first use, then a
        non-blocking copy of its tile to pinned host memory under an
        event; on the CPU an eager run. Returns (tile, event or None)."""
        sampled = self._variant == "sampled"
        K = self.decode_steps
        if self.device.type != "cuda":
            tile = self._decode_tile(sampled, K)
            self._phases.mark("decode.dispatch")
            return tile, None
        key = (sampled, K)
        prog = self._graphs.get(key)
        cold = prog is None
        if cold:
            prog = self._capture(sampled, K)
            self._graphs[key] = prog
            self.graph_captures += 1
            _metric("jit_retrace_total").inc()
        prog.graph.replay()
        host = torch.empty(prog.tile.shape, dtype=prog.tile.dtype,
                           pin_memory=True)
        host.copy_(prog.tile, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._phases.mark("compile" if cold else "decode.dispatch")
        return host, event

    def _capture(self, sampled, K):
        """Capture the decode program as a CUDA graph. The warm-up run that
        capture needs goes with every lane dead, so it writes only the
        scratch block and leaves the lane state as it was. A failure
        raises: the engine never decodes eagerly on the card."""
        d = self._dev
        alive = d["alive"].clone()
        try:
            d["alive"].zero_()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._decode_tile(sampled, K)
            torch.cuda.current_stream(self.device).wait_stream(side)
            d["alive"].copy_(alive)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            tile = torch.zeros((self.max_batch, K), dtype=torch.int64,
                               device=self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._graph_pool):
                tile.copy_(self._decode_tile(sampled, K))
        except Exception as e:
            d["alive"].copy_(alive)
            raise RuntimeError(
                f"capturing the decode program (sampled={sampled}, K={K}) "
                f"as a CUDA graph failed: {e}") from e
        return _DecodeGraph(graph, tile)

    def _decode_tile(self, sampled, K):
        """The fused decode program: K steps of every lane over the static
        lane state and the pool, both updated in place. Returns the [B, K]
        int64 token tile. Dead lanes write their K/V to the scratch block
        and re-emit their last token (never credited: the host walk stops
        at the same eos/length boundary)."""
        d, cfg = self._dev, self.cfg
        eps, theta = cfg["eps"], cfg["theta"]
        nh, nkv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
        scratch = self.pool.scratch_block
        toks, lens, alive, rem = d["toks"], d["lens"], d["alive"], d["rem"]
        tables = d["tables"]
        B = toks.shape[0]
        out = []
        for _ in range(K):
            h = self.embed_w[toks][:, None]                     # (B, 1, H)
            pos = lens[:, None]                                 # write pos
            for li, lp in enumerate(self.layers):
                kc, vc = self.pool.k[li], self.pool.v[li]
                x = _rms(h, lp["input_layernorm.weight"], eps)
                q = (x @ lp["self_attn.q_proj.weight"]).reshape(B, 1, nh, hd)
                k = (x @ lp["self_attn.k_proj.weight"]).reshape(B, 1, nkv,
                                                                hd)
                v = (x @ lp["self_attn.v_proj.weight"]).reshape(B, 1, nkv,
                                                                hd)
                q = _rope(q, pos, theta)[:, 0]
                k = _rope(k, pos, theta)[:, 0]
                kv_write_token(None, kc, vc, None, None, k, v[:, 0], tables,
                               lens, active=alive, scratch_block=scratch)
                attn = paged_attention_decode_inner(
                    q, kc, vc, tables, lens + 1, scale=1.0 / (hd ** 0.5))
                h = h + (attn.reshape(B, 1, nh * hd)
                         @ lp["self_attn.o_proj.weight"])
                h = _mlp(lp, h, eps)
            logits = (_rms(h[:, 0], self.norm_w, eps) @ self._out_w).float()
            nxt = torch.argmax(logits, dim=-1)
            if sampled:
                samp = _device_sample(logits, d["seeds"], lens, d["temp"],
                                      d["top_k"], d["top_p"])
                nxt = torch.where(d["do_sample"], samp, nxt)
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
        # one dispatch advances every active lane K tokens, so the
        # dispatch->readback wall over K is the per-token latency; the
        # first live lane's trace id stands for the tile
        ex = None
        if self._reg.enabled:
            for r in infl.reqs:
                if r is not None and not r.done:
                    ex = r.trace_id
                    break
        per_tok = (t1 - infl.t_dispatch) / infl.k
        self._m_tpot.observe(per_tok, exemplar=ex)
        for t in sorted({r.tenant for r in infl.reqs
                         if r is not None and not r.done}):
            _metric("serving_tenant_tpot_seconds",
                    tenant=t).observe(per_tok)
        if self._rec.enabled:
            self._rec.record("readback", tile=infl.tile_id,
                             wait_ms=round((t1 - t0) * 1e3, 3))
        if self._tracer.enabled:
            self._trace_tile(infl, t1)
        self._process_tile(arr, infl)
        ph = self._phases
        if ph.enabled:
            ph.mark("commit")
            tenants = sorted({r.tenant for r in infl.reqs if r is not None})
            ph.credit_tenants(tenants, t1 - infl.t_dispatch)
        return True

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

    # --- device-resident lane state ---------------------------------------
    def _upload_lane_state(self, active):
        """Refill the device lane state from the host mirrors, in place —
        called only on membership change (admission / retire / shed),
        never in the steady state."""
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
        sampled = any(self.lanes[i].do_sample for i in active)
        for i in active:
            r = self.lanes[i]
            t = self.pool.tables[r.rid]
            tables[i, :len(t)] = t
            lens[i] = self.lane_len[i]
            toks[i] = self.lane_tok[i]
            alive[i] = True
            rem[i] = r.max_new_tokens - len(r.generated)
            if r.eos_token_id is not None:
                eos[i] = r.eos_token_id
            if r.do_sample:
                do_s[i] = True
                seeds[i] = int(r.sample_seed)
                temp[i] = max(r.temperature, 1e-6)
                top_k[i] = r.top_k
                top_p[i] = r.top_p
        for name, host in (("tables", tables), ("lens", lens),
                           ("toks", toks), ("alive", alive), ("rem", rem),
                           ("eos", eos), ("seeds", seeds),
                           ("do_sample", do_s), ("temp", temp),
                           ("top_k", top_k), ("top_p", top_p)):
            self._dev[name].copy_(torch.from_numpy(host))
        self._variant = "sampled" if sampled else "greedy"
        self._dirty = False
        self._m_uploads.inc()
        if self._rec.enabled:
            self._rec.record("membership", active=list(active),
                             variant=self._variant)


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

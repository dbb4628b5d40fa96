#!/usr/bin/env python
"""Chaos drill: run the fault-injection matrix across every registered
site the port fires and report escapes (RESILIENCE.md's acceptance gate).

reference: tools/chaos_drill.py.

Usage:
  python3 -m paddle_tpu_torch.tools.chaos_drill              # on CUDA
  python3 -m paddle_tpu_torch.tools.chaos_drill --device cpu
  python3 -m paddle_tpu_torch.tools.chaos_drill -v           # + notes
  python3 -m paddle_tpu_torch.tools.chaos_drill --site serve.decode_oom

For each site in paddle_tpu_torch.resilience.faults.FAULT_SITES the drill
arms a deterministic spec, drives the subsystem that owns the site (its
tiny engines on DEVICE: the card unless `--device cpu`), and classifies
the outcome:

  recovered  the retry layer absorbed the fault; the operation finished
             with a correct result
  degraded   the fault surfaced as a TYPED, counted error or a degraded
             completion (atomic rollback, finish_reason, skip-batch)
  ESCAPED    an injected fault came out as an unhandled exception, a
             postcondition failed, or the site's fault_injected_total did
             not move — the drill exits nonzero

Every scenario also asserts the matching catalog counters moved, so a
fault can never be silently swallowed either. The five `compile.*` sites
of the PIR pipeline (cache read and write, the verifier, the fusion pass,
the sharding propagation) are drilled on a two-op program compiled on
DEVICE. Any registered site without a scenario fails the drill.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import traceback

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                     save_state_dict)
from paddle_tpu_torch.observability import recorder as flight
from paddle_tpu_torch.resilience import RetryPolicy, TrainSupervisor, faults

# where the tiny engines run (main's --device)
DEVICE = "cuda"
TINY_KNOBS = dict(num_blocks=64, block_size=8, max_batch=2,
                  prefill_buckets=(16,))
# registered sites the drill leaves out (none: every site is drilled)
NOT_DRILLED = ()
NOT_DRILLED_WHY = "not drilled"


class Escape(AssertionError):
    pass


def _expect(cond, what):
    if not cond:
        raise Escape(what)


def _counter(name, **labels):
    fam = obs.get_registry().get(name)
    if fam is None:
        return 0.0
    return (fam.labels(**labels) if labels else fam).value


def _counter_sum(name):
    """Total across every label set of one family (0.0 if unregistered)."""
    fam = obs.get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(c.value for c in fam.children().values())


# ---------------------------------------------------------------------------
# scenarios — one per fault site; each returns (outcome, note)
# ---------------------------------------------------------------------------

def drill_ckpt_chunk_write(tmp):
    with faults.injected_faults("ckpt.chunk_write:1:OSError"):
        save_state_dict({"w": torch.arange(8.0)}, tmp)
        inj = faults.injected_counts().get("ckpt.chunk_write", 0)
    _expect(inj == 1, "fault never reached the chunk-write site")
    target = {"w": torch.zeros(8)}
    load_state_dict(target, tmp)
    _expect(np.array_equal(target["w"].numpy(),
                           np.arange(8.0, dtype=np.float32)),
            "reloaded values differ after retried write")
    _expect(_counter("resilience_retries_total", op="ckpt.chunk_write") >= 1,
            "retry not counted")
    return "recovered", "OSError on chunk write retried; reload verified"


def drill_ckpt_metadata_replace(tmp):
    save_state_dict({"w": torch.full((4,), 1.0)}, tmp)
    try:
        with faults.injected_faults("ckpt.metadata_replace:1:RuntimeError"):
            save_state_dict({"w": torch.full((4,), 2.0)}, tmp)
        raise Escape("fatal mid-save fault did not surface")
    except RuntimeError as e:
        _expect("injected fault" in str(e), f"wrong error: {e!r}")
    target = {"w": torch.zeros(4)}
    load_state_dict(target, tmp)
    _expect(float(target["w"][0]) == 1.0,
            "reload did not fall back to the previous complete checkpoint")
    return "degraded", ("kill-mid-save surfaced typed; previous checkpoint "
                        "still loads (atomicity held)")


def _mk_store():
    from paddle_tpu_torch.distributed.store import ResilientStore, TCPStore
    inner = TCPStore(is_master=True, port=0)
    return ResilientStore(inner, policy=RetryPolicy(
        max_attempts=4, base_delay=0.001, seed=0))


def drill_store_get(tmp):
    st = _mk_store()
    st.set("k", b"v")
    with faults.injected_faults("store.get:1:TimeoutError"):
        val = st.get("k")
    _expect(val == b"v", f"retried get returned {val!r}")
    _expect(_counter("resilience_retries_total", op="store.get") >= 1,
            "retry not counted")
    return "recovered", "TimeoutError on get retried through ResilientStore"


def drill_store_set(tmp):
    st = _mk_store()
    with faults.injected_faults("store.set:1:ConnectionError"):
        st.set("k2", b"v2")
    _expect(st.get("k2") == b"v2", "value lost across retried set")
    return "recovered", "ConnectionError on set retried through ResilientStore"


def drill_elastic_heartbeat(tmp):
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.distributed.store import TCPStore
    store = TCPStore(is_master=True, port=0)
    em = ElasticManager(store, node_id="drill0", np_range=(1, 1),
                        heartbeat_interval=0.2,
                        retry_policy=RetryPolicy(max_attempts=3,
                                                 base_delay=0.001, seed=0))
    em.register()
    with faults.injected_faults("elastic.heartbeat:1:TimeoutError"):
        em._store_call(em._beat, op="elastic.heartbeat",
                       recovery_metric="elastic_heartbeat_recoveries_total")
    _expect(em.alive_nodes() == ["drill0"],
            "lease missing after retried heartbeat")
    _expect(_counter("elastic_heartbeat_recoveries_total") >= 1,
            "recovery not counted")
    return "recovered", "heartbeat survived a store blip inside the ttl"


def _tiny_engine(**kw):
    """The drill's engine: the reference drill's tiny llama (vocab 128,
    hidden 64, 2 layers, 4 heads, float32, weights from seed(0)) on
    DEVICE, with a small paged pool."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=256)
    paddle.seed(0)
    model = LlamaForCausalLM(cfg, device=DEVICE)
    for key, val in TINY_KNOBS.items():
        kw.setdefault(key, val)
    return model, ContinuousBatchingEngine(model, **kw)


def _dense_ref(model, prompt, n):
    """The greedy continuation a fault-free run gives. On the CPU, the
    dense-cache generate, as the reference drill holds it. On the card, a
    fresh unfaulted engine over the same model: generate's dense attention
    and the engine's paged attention sum in another order there, so their
    float32 streams may part at a near-tie, while the engine's own are
    exact."""
    if DEVICE == "cpu":
        from paddle_tpu_torch.generation import generate
        ids = torch.as_tensor(np.asarray(prompt, np.int64))[None]
        out = generate(model, ids, max_new_tokens=n, do_sample=False)
        return out[0, len(prompt):].tolist()
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **TINY_KNOBS)
    rid = eng.add_request(np.asarray(prompt), max_new_tokens=n)
    return eng.run()[rid]


def drill_serve_admit(tmp):
    model, eng = _tiny_engine()
    p = np.arange(6) % 128
    rid = eng.add_request(p, max_new_tokens=5)
    with faults.injected_faults("serve.admit:1:TimeoutError"):
        out = eng.run()
    _expect(out[rid] == _dense_ref(model, p, 5),
            "request did not complete correctly after admit fault")
    _expect(_counter("serving_deferred_total", reason="admit_fault") >= 1,
            "admit fault not counted as deferral")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "recovered", "admission fault deferred + retried; output exact"


def drill_serve_decode_oom(tmp):
    model, eng = _tiny_engine()
    p = (np.arange(7) * 3) % 128
    rid = eng.add_request(p, max_new_tokens=6)
    with faults.injected_faults("serve.decode_oom:1:MemoryError"):
        out = eng.run()
    _expect(out[rid] == _dense_ref(model, p, 6),
            "request did not complete correctly after shed")
    _expect(eng.finished[rid].shed_count == 1, "shed not recorded")
    _expect(_counter("serving_shed_total") >= 1, "shed not counted")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "recovered", "decode OOM shed + requeued; full completion"


def drill_serve_prefill_chunk(tmp):
    model, eng = _tiny_engine()
    p = (np.arange(20) * 7) % 128   # 2 chunks at the 16-wide bucket
    rid = eng.add_request(p, max_new_tokens=5)
    with faults.injected_faults("serve.prefill_chunk:2:TimeoutError"):
        out = eng.run()
    _expect(out[rid] == _dense_ref(model, p, 5),
            "request did not complete correctly after mid-prefill fault")
    _expect(_counter("serving_deferred_total", reason="prefill_fault") >= 1,
            "prefill fault not counted as deferral")
    _expect(_counter("serving_prefill_chunks_total") >= 3,
            "retried prefill did not restart from the first chunk")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "recovered", ("fault mid-chunked-prefill aborted the task; "
                         "requeued at front, fresh prefill; output exact")


def drill_serve_hostsync_read(tmp):
    model, eng = _tiny_engine()
    p = (np.arange(9) * 5) % 128
    rid = eng.add_request(p, max_new_tokens=6)
    with faults.injected_faults("serve.hostsync_read:1:TimeoutError"):
        out = eng.run()
    _expect(out[rid] == _dense_ref(model, p, 6),
            "request did not complete correctly after readback fault")
    _expect(_counter("serving_hostsync_retries_total") >= 1,
            "host-sync retry not counted")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "recovered", ("token-tile readback fault kept the tile in "
                         "flight; retried next step; output exact")


def drill_serve_draft_verify(tmp):
    model, eng = _tiny_engine(decode_steps=3, speculative_decode=True,
                              draft_depth=2)
    p = (np.arange(9) * 5) % 128
    rid = eng.add_request(p, max_new_tokens=12)
    with faults.injected_faults("serve.draft_verify:2:TimeoutError"):
        out = eng.run()
    _expect(out[rid] == _dense_ref(model, p, 12),
            "stream diverged after mid-flight speculation-off degradation")
    _expect(not eng.spec, "engine still speculative after the fault")
    _expect(_counter("serving_runtime_degradations_total",
                     what="speculation_off") >= 1,
            "degradation not counted")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "degraded", ("draft/verify fault dropped speculation for good; "
                        "in-flight spec tile drained, stream byte-exact")


def drill_serve_kv_dequant(tmp):
    model, eng = _tiny_engine(decode_steps=3, kv_cache_dtype="int8")
    p = (np.arange(9) * 5) % 128
    rid = eng.add_request(p, max_new_tokens=12)
    with faults.injected_faults("serve.kv_dequant:2:TimeoutError"):
        out = eng.run()
    _expect(len(out[rid]) == 12,
            "request did not complete after drop-to-bf16 degradation")
    _expect(not eng.pool.fmt.quantized,
            "pool still quantized after the fault")
    _expect(eng.pool.k_scale is None, "scale pool not released")
    _expect(_counter("serving_runtime_degradations_total",
                     what="kv_bf16") >= 1, "degradation not counted")
    hist = obs.get_registry().get("serving_kv_dequant_seconds")
    _expect(hist is not None and hist.count >= 1,
            "whole-pool dequant not timed")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "degraded", ("dequant fault converted the pool to bf16 once; "
                        "decode recompiled and the request completed")


def drill_serve_prefix_match(tmp):
    model, eng = _tiny_engine(prefix_cache=True)
    p = (np.arange(20) * 11) % 128   # 2 full blocks + a 4-token tail
    ref = _dense_ref(model, p, 6)
    # cold request: a miss that populates the index (2 shared blocks)
    rid0 = eng.add_request(p, max_new_tokens=6)
    _expect(eng.run()[rid0] == ref, "cold prefix-cache stream diverged")
    _expect(len(eng._prefix) == 2, "prompt blocks not indexed after "
                                   "prefill")
    hits0 = _counter("serving_prefix_hits_total")
    deg0 = _counter("serving_runtime_degradations_total",
                    what="prefix_miss")
    # fault the warm lookup: the index op degrades to a PLAIN MISS —
    # full prefill, stream byte-identical, never a wrong hit
    with faults.injected_faults("serve.prefix_match:1:TimeoutError"):
        rid1 = eng.add_request(p, max_new_tokens=6)
        out1 = eng.run()
        inj = faults.injected_counts().get("serve.prefix_match", 0)
    _expect(inj == 1, "fault never reached the prefix-match site")
    _expect(out1[rid1] == ref, "degraded-to-miss stream diverged")
    _expect(_counter("serving_prefix_hits_total") == hits0,
            "faulted lookup counted as a hit")
    _expect(_counter("serving_runtime_degradations_total",
                     what="prefix_miss") - deg0 >= 1,
            "prefix degradation not counted")
    # fault cleared: the same prompt must hit the warm index again and
    # skip the shared-block prefill, still byte-identical
    rid2 = eng.add_request(p, max_new_tokens=6)
    _expect(eng.run()[rid2] == ref, "warm prefix-cache stream diverged")
    _expect(_counter("serving_prefix_hits_total") - hits0 >= 1,
            "warm lookup did not hit after the fault cleared")
    _expect(_counter("serving_prefix_tokens_saved_total") >= 16,
            "prefill-token savings not counted")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "degraded", ("prefix-index fault degraded that lookup to a "
                        "cache miss (full prefill, bytes exact); next "
                        "admission hit the warm index again")


def drill_serve_loadgen_tick(tmp):
    from paddle_tpu_torch.inference import loadgen
    from paddle_tpu_torch.profiler.phases import get_phase_accountant
    acct = get_phase_accountant()
    prev = acct.enabled
    p = (np.arange(8) * 5) % 128
    try:
        # off-path proof first: the phase accountant toggled on/off must
        # not change one byte of greedy output (fresh engine each leg;
        # paddle.seed(0) in _tiny_engine makes the weights identical)
        acct.enabled = False
        model_off, eng_off = _tiny_engine()
        rid = eng_off.add_request(p, max_new_tokens=6)
        out_off = eng_off.run()[rid]
        acct.enabled = True
        model_on, eng_on = _tiny_engine()
        rid = eng_on.add_request(p, max_new_tokens=6)
        out_on = eng_on.run()[rid]
        _expect(out_off == out_on,
                "profiler on/off changed greedy output bytes")
        _expect(out_on == _dense_ref(model_on, p, 6),
                "greedy output diverged from the dense reference")
        # now the tick fault: one injected clock blip mid-run — the tick
        # is skipped + counted, its arrivals re-issued on the next tick
        skipped0 = _counter("loadgen_ticks_skipped_total")
        model, eng = _tiny_engine(num_blocks=128, max_batch=2)
        with faults.injected_faults("serve.loadgen_tick:2:TimeoutError"):
            rep = loadgen.run_scenario(eng, "chat", seed=1, rate_rps=30.0,
                                       duration_s=0.3, sample_every_s=0.1)
            inj = faults.injected_counts().get("serve.loadgen_tick", 0)
        _expect(inj == 1, "fault never reached the loadgen tick site")
        _expect(rep["ticks_skipped"] == 1,
                f"skipped ticks {rep['ticks_skipped']} != 1")
        _expect(_counter("loadgen_ticks_skipped_total") - skipped0 >= 1,
                "skipped tick not counted")
        _expect(rep["issued"] + rep["rejected"]
                == rep["schedule"]["arrivals"],
                "skipped tick dropped arrivals (re-issue broken)")
        _expect(rep["goodput"] == 1.0,
                f"requests lost across the skipped tick: {rep['finished']}")
    finally:
        acct.enabled = prev
    return "recovered", ("tick fault skipped + counted; arrivals re-issued "
                         "next tick; profiler off-path byte-identical")


def drill_serve_sched_decide(tmp):
    from paddle_tpu_torch.inference import loadgen
    model, eng = _tiny_engine(num_blocks=128, max_batch=2, scheduler=True)
    with faults.injected_faults("serve.sched_decide:1:RuntimeError"):
        rep = loadgen.run_scenario(eng, "structured_output", seed=1,
                                   duration_s=0.4, sample_every_s=0.1)
        inj = faults.injected_counts().get("serve.sched_decide", 0)
    _expect(inj == 1, "fault never reached the scheduler decision site")
    _expect(eng.scheduler.fifo,
            "scheduler did not degrade to FIFO after the decision fault")
    _expect(_counter("serving_runtime_degradations_total",
                     what="sched_fifo") >= 1, "degradation not counted")
    unknown = set(rep["finished"]) - set(loadgen.KNOWN_FINISH_REASONS)
    _expect(not unknown, f"unknown finish reasons under FIFO: {unknown}")
    _expect(rep["issued"] == sum(rep["finished"].values()),
            f"requests lost across the degrade: issued={rep['issued']} "
            f"finished={rep['finished']}")
    _expect(eng._preempted == {}, "lane left parked after FIFO degrade")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    _expect(eng.decode_steps == eng._base_decode_steps,
            "brownout knobs not restored on FIFO degrade")
    return "degraded", ("RuntimeError in the scheduler decision degraded "
                        "admission to plain FIFO; every in-flight request "
                        "finished with a known reason, no lane stranded")


def drill_serve_preempt(tmp):
    model, eng = _tiny_engine(max_batch=1, scheduler=True)
    p = (np.arange(6) * 5) % 128
    ref = _dense_ref(model, p, 10)
    rid = eng.add_request(p, max_new_tokens=10, priority="batch")
    while not eng._decode_active():
        eng.step()
    lane = eng._decode_active()[0]
    with faults.injected_faults("serve.preempt:1:TimeoutError"):
        ok = eng._try_preempt(lane, why="drill")
        inj = faults.injected_counts().get("serve.preempt", 0)
    _expect(inj == 1, "fault never reached the preempt site")
    _expect(not ok, "preemption reported success despite the fault")
    _expect(_counter("serving_deferred_total", reason="preempt_fault") >= 1,
            "preempt fault not counted")
    out = eng.run()
    _expect(out[rid] == ref,
            "victim stream diverged after the aborted preemption")
    # clean preempt mid-decode: paged-KV stays resident, lane resumes,
    # and the stream is byte-identical to the dense reference
    rid2 = eng.add_request(p, max_new_tokens=10, priority="batch")
    while not eng._decode_active():
        eng.step()
    eng.step()
    eng.step()
    _expect(eng._try_preempt(eng._decode_active()[0], why="drill"),
            "clean preemption refused")
    _expect(eng._preempted, "preempted lane not parked")
    out2 = eng.run()
    _expect(out2[rid2] == ref, "stream diverged across preempt/resume")
    _expect(eng._preempted == {}, "parked lane never resumed")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    return "recovered", ("preempt fault aborted the attempt (victim kept "
                         "decoding, exact stream); clean preempt/resume "
                         "also byte-identical")


def _tiny_adapter_engine(names=("lora0", "lora1"), **kw):
    """_tiny_engine + the deterministic demo AdapterStore (installed on
    the cold engine, before any program compiles). paddle.seed(0) in
    _tiny_engine plus the store's fixed weight seed make every build
    byte-identical, so fresh-engine streams are valid references."""
    from paddle_tpu_torch.inference.adapters import demo_store_for_engine
    model, eng = _tiny_engine(**kw)
    eng.adapters = demo_store_for_engine(eng, list(names))
    return model, eng


def _adapter_ref(adapter, p, n):
    """Unfaulted reference stream for (adapter, prompt): a fresh engine
    + store serving exactly one request."""
    model, eng = _tiny_adapter_engine()
    rid = eng.add_request(p, max_new_tokens=n, adapter=adapter)
    return eng.run()[rid]


def drill_serve_adapter_load(tmp):
    p0 = (np.arange(7) * 3) % 128
    p1 = (np.arange(7) * 5) % 128
    ref0 = _adapter_ref("lora0", p0, 6)
    ref1 = _adapter_ref("lora1", p1, 6)
    model, eng = _tiny_adapter_engine()
    rej0 = _counter("serving_rejected_total", reason="adapter")
    fail0 = _counter_sum("serving_adapter_load_failures_total")
    with faults.injected_faults("serve.adapter_load:1:TimeoutError"):
        rid_a = eng.add_request(p0, max_new_tokens=6, adapter="lora0")
        rid_b = eng.add_request(p1, max_new_tokens=6, adapter="lora1")
        out = eng.run()
        inj = faults.injected_counts().get("serve.adapter_load", 0)
    _expect(inj == 1, "fault never reached the adapter-load site")
    _expect(eng.finished[rid_a].finish_reason == "rejected",
            "faulted adapter bind did not finish as a typed rejection")
    _expect(not out.get(rid_a),
            "rejected request produced tokens (wrong-weights risk)")
    _expect(out.get(rid_b) == ref1,
            "other-adapter stream diverged from its unfaulted reference")
    _expect(_counter("serving_rejected_total", reason="adapter")
            - rej0 >= 1, "adapter rejection not counted")
    _expect(_counter_sum("serving_adapter_load_failures_total")
            - fail0 >= 1, "load failure not counted")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    # fault cleared: the SAME adapter hot-loads and serves byte-exact
    rid_c = eng.add_request(p0, max_new_tokens=6, adapter="lora0")
    _expect(eng.run()[rid_c] == ref0,
            "adapter stream diverged after the fault cleared")
    _expect(all(v == 0 for v in eng.adapters._refs.values()),
            "adapter refs leaked across the drill")
    return "degraded", ("store fault at bind rejected that request "
                        "typed + counted; the co-queued adapter and the "
                        "post-clear retry both byte-exact")


def drill_serve_adapter_gather(tmp):
    p = (np.arange(8) * 5) % 128
    pb = (np.arange(6) * 7) % 128
    ref0 = _adapter_ref("lora0", p, 6)
    model, eng = _tiny_adapter_engine()
    base_ref = _dense_ref(model, pb, 6)
    rej0 = _counter("serving_rejected_total", reason="adapter")
    with faults.injected_faults("serve.adapter_gather:1:TimeoutError"):
        rid_a = eng.add_request(p, max_new_tokens=6, adapter="lora0")
        rid_b = eng.add_request(pb, max_new_tokens=6)   # base lane
        out = eng.run()
        inj = faults.injected_counts().get("serve.adapter_gather", 0)
    _expect(inj == 1, "fault never reached the adapter-gather site")
    _expect(eng.finished[rid_a].finish_reason == "rejected",
            "faulted slot validation did not reject typed")
    _expect(not out.get(rid_a),
            "rejected request produced tokens (stale-slot gather risk)")
    _expect(out.get(rid_b) == base_ref,
            "base lane diverged across the adapter-gather fault")
    _expect(_counter("serving_rejected_total", reason="adapter")
            - rej0 >= 1, "adapter rejection not counted")
    _expect(all(v == 0 for v in eng.adapters._refs.values()),
            "gather rejection leaked the acquired adapter ref")
    _expect(eng.pool.tables == {}, "pool blocks leaked")
    # fault cleared: the adapter (already resident from the acquire)
    # serves byte-identically to its unfaulted reference
    rid_c = eng.add_request(p, max_new_tokens=6, adapter="lora0")
    _expect(eng.run()[rid_c] == ref0,
            "adapter stream diverged after the fault cleared")
    return "degraded", ("slot-validation fault rejected typed with the "
                        "acquired ref released; base lane untouched; "
                        "post-clear adapter stream byte-exact")


def drill_train_step_nonfinite(tmp):
    losses = {"n": 0}

    def step_fn():
        losses["n"] += 1
        return 1.0 / losses["n"]

    sup = TrainSupervisor(step_fn)
    with faults.injected_faults("train.step_nonfinite:2:FaultInjected"):
        out = [sup.step() for _ in range(4)]
    _expect(out[1] is None and out[0] is not None and out[2] is not None,
            f"skip pattern wrong: {out}")
    _expect(sup.nonfinite_skips == 1, "skip not recorded")
    _expect(_counter("train_nonfinite_skips_total") >= 1,
            "skip not counted")
    return "degraded", "non-finite loss skipped-with-counter; run continued"


def _tiny_mesh(n=2, disaggregate=False, **kw):
    """N-replica in-process mesh over _tiny_engine workers (identical
    weights: the factory reseeds per build). Returns (model, pool,
    router) — the model for _dense_ref comparisons."""
    from paddle_tpu_torch.inference.mesh import MeshRouter, ReplicaPool
    holder = {}

    def factory():
        model, eng = _tiny_engine(**kw)
        holder.setdefault("model", model)
        return eng

    pool = ReplicaPool(factory, n=n, disaggregate=disaggregate,
                       store_port=0)
    return holder["model"], pool, MeshRouter(pool)


def drill_mesh_route(tmp):
    model, pool, router = _tiny_mesh()
    prompts = [(np.arange(6) * (i + 2)) % 128 for i in range(4)]
    refs = [_dense_ref(model, p, 6) for p in prompts]
    with faults.injected_faults("mesh.route:1:TimeoutError"):
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        inj = faults.injected_counts().get("mesh.route", 0)
    _expect(inj == 1, "fault never reached the route site")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "stream diverged after the re-routed replica pick")
    _expect(router._failovers.get("route_fault", 0) >= 1,
            "route fault not counted as a failover")
    _expect(_counter("mesh_failovers_total", reason="route_fault") >= 1,
            "mesh_failovers_total{route_fault} did not move")
    _expect(router.mesh_report()["open"] == 0,
            "mesh accounting left requests open")
    return "recovered", ("route fault failed the pick over to the "
                         "next-best replica; every stream byte-exact")


def drill_mesh_kv_handoff(tmp):
    # leg 1: transient — one ConnectionError mid-transfer, the handoff
    # retry absorbs it and the decode worker imports the same bytes
    model, pool, router = _tiny_mesh(disaggregate=True)
    prompts = [(np.arange(7) * (i + 3)) % 128 for i in range(3)]
    refs = [_dense_ref(model, p, 6) for p in prompts]
    with faults.injected_faults("mesh.kv_handoff:1:ConnectionError"):
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        inj = faults.injected_counts().get("mesh.kv_handoff", 0)
    _expect(inj == 1, "fault never reached the handoff site")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "stream diverged after the retried handoff")
    _expect(router._handoffs["retried"] >= 1, "handoff retry not recorded")
    _expect(_counter("mesh_handoffs_total", outcome="retried") >= 1,
            "mesh_handoffs_total{retried} did not move")
    # leg 2: exhaustion — every retry attempt of the first handoff
    # fails; the stream must re-prefill on the decode side and still
    # come out byte-identical
    model2, pool2, router2 = _tiny_mesh(disaggregate=True)
    with faults.injected_faults("mesh.kv_handoff:1:ConnectionError;"
                                "mesh.kv_handoff:2:ConnectionError;"
                                "mesh.kv_handoff:3:ConnectionError"):
        rids2 = [router2.add_request(p, max_new_tokens=6) for p in prompts]
        out2 = router2.run()
    for rid, ref in zip(rids2, refs):
        _expect(out2.get(rid) == ref,
                "stream diverged after handoff exhaustion + re-prefill")
    _expect(router2._handoffs["re_prefill"] >= 1,
            "exhausted handoff did not fall back to re-prefill")
    _expect(_counter("mesh_handoffs_total", outcome="re_prefill") >= 1,
            "mesh_handoffs_total{re_prefill} did not move")
    _expect(router.mesh_report()["open"] == 0
            and router2.mesh_report()["open"] == 0,
            "mesh accounting left requests open")
    return "recovered", ("transient handoff fault retried (same bytes); "
                         "exhaustion re-prefilled on the decode worker; "
                         "streams byte-exact both ways")


def drill_mesh_replica_down(tmp):
    model, pool, router = _tiny_mesh(n=2)
    prompts = [(np.arange(6) * (i + 5)) % 128 for i in range(4)]
    refs = [_dense_ref(model, p, 8) for p in prompts]
    with faults.injected_faults("mesh.replica_down:2:FaultInjected"):
        rids = [router.add_request(p, max_new_tokens=8) for p in prompts]
        out = router.run()
        inj = faults.injected_counts().get("mesh.replica_down", 0)
    _expect(inj == 1, "fault never reached the replica-down site")
    _expect(len(pool.alive()) == 1, "kill did not tombstone the replica")
    _expect(pool.alive_nodes() == [pool.alive()[0].name],
            "elastic membership disagrees with the pool after the kill")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "re-routed stream diverged from the dense reference")
    _expect(router._failovers.get("replica_down", 0) >= 1,
            "replica_down failover not counted")
    _expect(_counter("mesh_failovers_total", reason="replica_down") >= 1,
            "mesh_failovers_total{replica_down} did not move")
    rep = router.mesh_report()
    _expect(rep["open"] == 0, "mesh accounting left requests open")
    _expect(len(out) == len(rids), "an admitted request never completed")
    return "degraded", ("replica killed mid-run; its streams re-routed + "
                        "re-prefilled on the survivor, byte-identical; "
                        "accounting closed")


def _tiny_process_mesh(n=2, disaggregate=False, op_timeout_s=None,
                       router_kw=None, **kw):
    """N-replica loopback ProcessReplicaPool: same tiny engines, but
    every router<->worker interaction marshals through the versioned
    frame protocol (the round-20 transport). op_timeout_s tightens the
    per-op deadline budget (the gray-failure drills need one shorter
    than the injected stall); router_kw reaches MeshRouter (health
    detector, hedge budget)."""
    from paddle_tpu_torch.inference.mesh import MeshRouter, ProcessReplicaPool
    holder = {}

    def factory():
        model, eng = _tiny_engine(**kw)
        holder.setdefault("model", model)
        return eng

    pool = ProcessReplicaPool(factory, n=n, disaggregate=disaggregate,
                              store_port=0, op_timeout_s=op_timeout_s)
    return holder["model"], pool, MeshRouter(pool, **(router_kw or {}))


def drill_mesh_transport_send(tmp):
    # leg 1: transient — one ConnectionError as the first frame leaves
    # the client. The site arms BEFORE dispatch, so the retried send
    # cannot double-admit; the transport retry absorbs it silently.
    model, pool, router = _tiny_process_mesh()
    prompts = [(np.arange(6) * (i + 2)) % 128 for i in range(4)]
    refs = [_dense_ref(model, p, 6) for p in prompts]
    with faults.injected_faults("mesh.transport_send:1:ConnectionError"):
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        inj = faults.injected_counts().get("mesh.transport_send", 0)
    _expect(inj == 1, "fault never reached the transport send site")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "stream diverged after the retried frame send")
    _expect(_counter("resilience_retries_total",
                     op="mesh.transport_send") >= 1,
            "transport retry not counted")
    _expect(_counter("mesh_transport_frames_total",
                     kind="add_request") >= 1,
            "mesh_transport_frames_total{add_request} did not move")
    # leg 2: exhaustion — every attempt of the first send fails. The
    # worker latches LOST (exactly a killed process: admission refuses,
    # the breaker slams) and the survivor serves every stream
    # byte-identically through the admit_failed failover.
    model2, pool2, router2 = _tiny_process_mesh()
    with faults.injected_faults("mesh.transport_send:1:ConnectionError;"
                                "mesh.transport_send:2:ConnectionError;"
                                "mesh.transport_send:3:ConnectionError"):
        rids2 = [router2.add_request(p, max_new_tokens=6) for p in prompts]
        out2 = router2.run()
    for rid, ref in zip(rids2, refs):
        _expect(out2.get(rid) == ref,
                "stream diverged after transport loss + failover")
    _expect(len(pool2.alive()) == 1,
            "exhausted transport did not latch the worker lost")
    _expect(router2._failovers.get("admit_failed", 0) >= 1,
            "lost-worker admission not counted as a failover")
    _expect(router.mesh_report()["open"] == 0
            and router2.mesh_report()["open"] == 0,
            "mesh accounting left requests open")
    return "recovered", ("transient frame fault retried before dispatch "
                         "(no double-admit); exhaustion latched the "
                         "worker lost and the survivor served every "
                         "stream byte-exact")


def drill_mesh_controller_act(tmp):
    from paddle_tpu_torch.inference.mesh import MeshController
    model, pool, router = _tiny_process_mesh()
    ctl = MeshController(router, min_replicas=1, max_replicas=3)
    router.controller = ctl
    prompts = [(np.arange(6) * (i + 4)) % 128 for i in range(3)]
    refs = [_dense_ref(model, p, 6) for p in prompts]
    # healthy action first: a scale_up verdict spawns + lease-registers
    ctl.act({"action": "scale_up"})
    _expect(len(pool.alive()) == 3, "scale_up did not spawn a worker")
    _expect(ctl.actions["scale_up"] == 1, "scale_up not counted")
    _expect(sorted(pool.alive_nodes())
            == sorted(r.name for r in pool.alive()),
            "spawned worker not lease-registered")
    # the fault: the controller tick inside the pump blows up — it must
    # latch back to advisory-only while serving does not notice
    with faults.injected_faults("mesh.controller_act:1:FaultInjected"):
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        inj = faults.injected_counts().get("mesh.controller_act", 0)
    _expect(inj == 1, "fault never reached the controller act site")
    _expect(not ctl.enabled, "controller did not latch advisory-only")
    _expect(ctl.actions["latch_off"] == 1, "latch_off not counted")
    _expect(_counter("mesh_controller_actions_total",
                     action="latch_off") >= 1,
            "mesh_controller_actions_total{latch_off} did not move")
    _expect(_counter("serving_runtime_degradations_total",
                     what="controller_advisory") >= 1,
            "controller degradation not counted")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "stream diverged after the controller latch")
    # latched means LATCHED: later verdicts are ignored, the pool holds
    ctl.act({"action": "scale_down"})
    _expect(len(pool.alive()) == 3 and ctl.actions["scale_down"] == 0,
            "latched controller still acted on a verdict")
    _expect(router.mesh_report()["open"] == 0,
            "mesh accounting left requests open")
    return "degraded", ("controller fault latched it back to "
                        "advisory-only (counted); pool membership held "
                        "and serving stayed byte-identical")


def drill_mesh_net_delay(tmp):
    # a SHORT hold on one worker reply (~50 ms against a 30 s per-op
    # budget): the deadline-aware transport absorbs it entirely —
    # nobody times out, nobody is demoted, nothing re-routes.
    model, pool, router = _tiny_process_mesh()
    prompts = [(np.arange(6) * (i + 3)) % 128 for i in range(4)]
    refs = [_dense_ref(model, p, 6) for p in prompts]
    rpc0 = _counter_sum("mesh_rpc_timeouts_total")
    slow0 = _counter_sum("mesh_slow_demotions_total")
    with faults.injected_faults("mesh.net_delay:1:TimeoutError"):
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        inj = faults.injected_counts().get("mesh.net_delay", 0)
    _expect(inj == 1, "fault never reached the net-delay site")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "stream diverged across the delayed reply")
    _expect(_counter_sum("mesh_rpc_timeouts_total") == rpc0,
            "a sub-budget delay raised a transport timeout")
    _expect(_counter_sum("mesh_slow_demotions_total") == slow0,
            "a sub-budget delay demoted a replica")
    _expect(len(pool.alive()) == 2, "a sub-budget delay killed a replica")
    _expect(router.mesh_report()["open"] == 0,
            "mesh accounting left requests open")
    return "recovered", ("50 ms reply hold absorbed by the per-op "
                         "deadline budget: no timeout, no demotion, "
                         "streams byte-exact")


def drill_mesh_net_stall(tmp):
    # a LONG hold (~0.75 s against a 50 ms budget, well short of the
    # dead threshold): the op times out TYPED, the health detector
    # demotes the replica SLOW — never DEAD — the hedger covers its
    # in-flight streams, and the first finish wins byte-identically.
    from paddle_tpu_torch.inference.mesh import HealthDetector
    det = HealthDetector(slow_phi=0.5, dead_phi=50.0, slow_elapsed_s=0.1,
                         dead_elapsed_s=10.0)
    model, pool, router = _tiny_process_mesh(
        op_timeout_s=0.05,
        router_kw={"health": det, "hedge_budget_s": 0.3})
    prompts = [(np.arange(6) * (i + 7)) % 128 for i in range(4)]
    refs = [_dense_ref(model, p, 8) for p in prompts]
    rpc0 = _counter("mesh_rpc_timeouts_total", op="step")
    slow0 = _counter_sum("mesh_slow_demotions_total")
    down0 = _counter("mesh_failovers_total", reason="replica_down")
    rids = [router.add_request(p, max_new_tokens=8) for p in prompts]
    for _ in range(2):      # calibrate: land real replies first
        router.step()
    with faults.injected_faults("mesh.net_stall:1:TimeoutError"):
        out = router.run()
        inj = faults.injected_counts().get("mesh.net_stall", 0)
    _expect(inj == 1, "fault never reached the net-stall site")
    for rid, ref in zip(rids, refs):
        _expect(out.get(rid) == ref,
                "stream diverged across the stalled worker")
    _expect(_counter("mesh_rpc_timeouts_total", op="step") > rpc0,
            "stalled step never raised the typed transport timeout")
    _expect(_counter_sum("mesh_slow_demotions_total") > slow0,
            "stalled replica was never demoted SLOW")
    _expect(len(pool.alive()) == 2,
            "gray stall escalated to a kill (SLOW must trip before DEAD)")
    _expect(_counter("mesh_failovers_total", reason="replica_down")
            == down0, "gray stall walked the replica_down path")
    rep = router.mesh_report()
    _expect(rep["open"] == 0, "mesh accounting left requests open")
    _expect(len(out) == len(rids), "an admitted request never completed")
    return "degraded", ("0.75 s stall went gray: typed step timeouts, "
                        "SLOW demotion (no kill, no replica_down), "
                        "hedged placements, streams byte-exact")


def drill_obs_sample(tmp):
    from paddle_tpu_torch.observability.timeseries import MetricsSampler
    p = (np.arange(8) * 5) % 128
    # off-path proof first: the observability plane attached, disabled,
    # or absent must not change one byte of greedy output (fresh engine
    # each leg; paddle.seed(0) in _tiny_engine makes weights identical)
    model_off, eng_off = _tiny_engine()
    rid = eng_off.add_request(p, max_new_tokens=6)
    out_off = eng_off.run()[rid]
    model_on, eng_on = _tiny_engine()
    eng_on.sampler = MetricsSampler()
    rid = eng_on.add_request(p, max_new_tokens=6)
    out_on = eng_on.run()[rid]
    _expect(out_off == out_on,
            "sampler attached changed greedy output bytes")
    _expect(out_on == _dense_ref(model_on, p, 6),
            "greedy output diverged from the dense reference")
    _expect(eng_on.sampler.samples >= 1,
            "sampler never landed a tick on the engine step clock")
    model_dis, eng_dis = _tiny_engine()
    eng_dis.sampler = MetricsSampler()
    eng_dis.sampler.enabled = False
    rid = eng_dis.add_request(p, max_new_tokens=6)
    _expect(eng_dis.run()[rid] == out_off,
            "disabled-sampler fast path changed greedy output bytes")
    _expect(eng_dis.sampler.samples == 0,
            "disabled sampler scraped anyway")
    # now the fault: a scrape blows up mid-run — the plane flips to
    # degraded (off, counted) and serving output is untouched
    deg0 = _counter("obs_plane_degradations_total", what="FaultInjected")
    model, eng = _tiny_engine()
    eng.sampler = MetricsSampler()
    with faults.injected_faults("obs.sample:2:FaultInjected"):
        rid = eng.add_request(p, max_new_tokens=6)
        out = eng.run()[rid]
        inj = faults.injected_counts().get("obs.sample", 0)
    _expect(inj == 1, "fault never reached the sampler scrape site")
    _expect(out == out_off, "sampler fault changed serving output bytes")
    _expect(eng.sampler.degraded, "sampler fault did not mark the plane "
            "degraded")
    _expect(not eng.sampler.enabled, "degraded sampler still enabled")
    _expect(_counter("obs_plane_degradations_total",
                     what="FaultInjected") - deg0 >= 1,
            "plane degradation not counted")
    ticks = eng.sampler.samples
    eng.sampler.sample()
    _expect(eng.sampler.samples == ticks,
            "degraded sampler kept scraping (plane-off not latched)")
    return "degraded", ("scrape fault mid-run latched the plane off, "
                        "counted; serving bytes identical with the plane "
                        "on, off, and mid-run killed")


def _pir_compile_setup(tmp):
    """A two-op program (tanh(x @ y).sum()) on DEVICE and a fresh compile
    cache directory; returns (pir, fn, args, want, previous cache dir)."""
    from paddle_tpu_torch import pir
    from paddle_tpu_torch.framework import flags as _flags

    def fn(x, y):
        return (torch.tanh(x @ y).sum(),)

    x = torch.ones(4, 4, device=DEVICE)
    y = torch.eye(4, device=DEVICE) * 2.0
    want = float(np.tanh(2.0) * 16)
    prev = _flags.flag_value("compile_cache_dir")
    _flags.set_flags({"compile_cache_dir": os.path.join(tmp, "pirc")})
    return pir, fn, [x, y], want, prev


def drill_compile_cache_read(tmp):
    from paddle_tpu_torch.framework import flags as _flags
    pir, fn, args, want, prev = _pir_compile_setup(tmp)
    try:
        _, rep0 = pir.compile_flat(fn, args, name="drill")   # seed artifact
        _expect(rep0.cache == "miss", f"seed compile was {rep0.cache}")
        with faults.injected_faults("compile.cache_read:1:OSError"):
            warm, rep = pir.compile_flat(fn, args, name="drill")
            inj = faults.injected_counts().get("compile.cache_read", 0)
        _expect(inj == 1, "fault never reached the cache-read site")
        _expect(rep.cache.startswith("error:read"),
                f"read fault not surfaced in report: {rep.cache}")
        out = float(warm(*args)[0])
        _expect(abs(out - want) < 1e-5, f"recompiled result wrong: {out}")
        _expect(_counter("fault_injected_total",
                         site="compile.cache_read") >= 1,
                "injection not counted")
        _, rep2 = pir.compile_flat(fn, args, name="drill")
        _expect(rep2.cache == "hit", f"artifact lost after read fault: "
                                     f"{rep2.cache}")
    finally:
        _flags.set_flags({"compile_cache_dir": prev})
    return "recovered", ("read fault degraded to the fresh compile; the "
                         "artifact survived and re-verified as a hit")


def drill_compile_cache_write(tmp):
    from paddle_tpu_torch.framework import flags as _flags
    pir, fn, args, want, prev = _pir_compile_setup(tmp)
    try:
        with faults.injected_faults("compile.cache_write:1:OSError"):
            cold, rep = pir.compile_flat(fn, args, name="drill")
            inj = faults.injected_counts().get("compile.cache_write", 0)
        _expect(inj == 1, "fault never reached the cache-write site")
        _expect(rep.cache.startswith("error:write"),
                f"write fault not surfaced in report: {rep.cache}")
        out = float(cold(*args)[0])
        _expect(abs(out - want) < 1e-5,
                f"compile result wrong after write fault: {out}")
        _, rep2 = pir.compile_flat(fn, args, name="drill")
        _expect(rep2.cache == "miss", f"expected miss, got {rep2.cache}")
        _, rep3 = pir.compile_flat(fn, args, name="drill")
        _expect(rep3.cache == "hit", f"retried write not readable: "
                                     f"{rep3.cache}")
    finally:
        _flags.set_flags({"compile_cache_dir": prev})
    return "degraded", ("write fault left the compile uncached but "
                        "working; the next compile wrote and verified")


def drill_compile_verify(tmp):
    from paddle_tpu_torch.framework import flags as _flags
    pir, fn, args, want, prev = _pir_compile_setup(tmp)
    prev_v = _flags.flag_value("pir_verify")
    _flags.set_flags({"pir_verify": "boundary"})
    try:
        with faults.injected_faults("compile.verify:1:RuntimeError"):
            compiled, rep = pir.compile_flat(fn, args, name="drill_verify")
            inj = faults.injected_counts().get("compile.verify", 0)
        _expect(inj == 1, "fault never reached the verifier entry")
        _expect(rep.fallback == "verify",
                f"verifier fault not degraded: fallback={rep.fallback}")
        out = float(compiled(*args)[0])
        _expect(abs(out - want) < 1e-5, f"fallback result wrong: {out}")
        _expect(_counter("pir_fallback_total", stage="verify") >= 1,
                "verify fallback not counted")
        clean, rep2 = pir.compile_flat(fn, args, name="drill_verify")
        _expect(rep2.fallback is None,
                f"still degraded after fault cleared: {rep2.fallback}")
        out2 = float(clean(*args)[0])
        _expect(abs(out2 - want) < 1e-5, f"clean recompile wrong: {out2}")
    finally:
        _flags.set_flags({"compile_cache_dir": prev, "pir_verify": prev_v})
    return "degraded", ("verifier fault ran that function as written "
                        "(correct numerics); the next compile verified and "
                        "took the PIR path")


def drill_compile_fuse(tmp):
    """Both blast radii of the fusion pass: hit 1 (the planning walk)
    runs the whole function as written, counted
    pir_fallback_total{stage=fuse}; hit 2 (the group's commit) skips that
    group only, the compile staying on the PIR path. Every leg must equal
    the fusion-off program bit for bit."""
    from paddle_tpu_torch.framework import flags as _flags
    pir, fn, args, want, prev = _pir_compile_setup(tmp)
    prev_passes = _flags.flag_value("pir_passes")
    no_fuse = ",".join(p for p in prev_passes.split(",")
                       if p.strip() != "fuse")
    try:
        _flags.set_flags({"pir_passes": no_fuse})
        off, rep_off = pir.compile_flat(fn, args, name="drill_fuse")
        _expect(rep_off.fallback is None,
                f"fusion-off reference degraded: {rep_off.fallback}")
        ref = off(*args)[0]
        _flags.set_flags({"pir_passes": prev_passes})

        with faults.injected_faults("compile.fuse:2:RuntimeError"):
            part, rep1 = pir.compile_flat(fn, args, name="drill_fuse")
            inj1 = faults.injected_counts().get("compile.fuse", 0)
        _expect(inj1 == 1, "fault never reached the per-group seam")
        _expect(rep1.fallback is None,
                f"per-group fault degraded the compile: {rep1.fallback}")
        _expect(rep1.fusion_groups == 0,
                f"skipped group still counted: {rep1.fusion_groups}")
        _expect(torch.equal(part(*args)[0], ref),
                "per-group skip not bit-identical to fusion-off")

        with faults.injected_faults("compile.fuse:1:RuntimeError"):
            plain, rep2 = pir.compile_flat(fn, args, name="drill_fuse")
            inj2 = faults.injected_counts().get("compile.fuse", 0)
        _expect(inj2 == 1, "fault never reached the fuse pass entry")
        _expect(rep2.fallback == "fuse",
                f"whole-pass fault not degraded: fallback={rep2.fallback}")
        _expect(torch.equal(plain(*args)[0], ref),
                "stage=fuse fallback not bit-identical to fusion-off")
        _expect(_counter("pir_fallback_total", stage="fuse") >= 1,
                "fuse fallback not counted")

        clean, rep3 = pir.compile_flat(fn, args, name="drill_fuse")
        _expect(rep3.fallback is None and rep3.fusion_groups >= 1,
                f"not fused after the fault cleared: fallback="
                f"{rep3.fallback} groups={rep3.fusion_groups}")
        _expect(torch.equal(clean(*args)[0], ref),
                "fused program not bit-identical to fusion-off")
    finally:
        _flags.set_flags({"compile_cache_dir": prev,
                          "pir_passes": prev_passes})
    return "degraded", ("per-group fault skipped that group on the PIR "
                        "path; pass-entry fault ran the function as "
                        "written; every leg bit-identical to fusion-off")


def drill_compile_shard_prop(tmp):
    """The sharding propagation's entry fault (reference
    tests/test_pir_sharding.py:305-339): the two-op program compiled under
    a 2x2 mesh scope with input shardings runs as written, counted
    pir_fallback_total{stage=passes}; a clean retry is sharded and equal."""
    from paddle_tpu_torch.distributed.placement import ProcessMesh
    from paddle_tpu_torch.pir.shard_prop import mesh_scope
    from paddle_tpu_torch.framework import flags as _flags
    pir, fn, args, want, prev = _pir_compile_setup(tmp)
    mesh = ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"], device=DEVICE)
    specs = [("dp", None), (None, "mp")]
    try:
        base = _counter("pir_fallback_total", stage="passes")
        with faults.injected_faults("compile.shard_prop:1:RuntimeError"):
            with mesh_scope(mesh):
                plain, rep = pir.compile_flat(fn, args, name="drill_shard",
                                              input_shardings=specs)
                out = float(plain(*args)[0])
            inj = faults.injected_counts().get("compile.shard_prop", 0)
        _expect(inj == 1, "fault never reached the shard_prop entry")
        _expect(rep.fallback == "passes",
                f"shard_prop fault not degraded: fallback={rep.fallback}")
        _expect(abs(out - want) < 1e-5, f"fallback result wrong: {out}")
        _expect(_counter("pir_fallback_total", stage="passes") == base + 1,
                "passes fallback not counted")
        with mesh_scope(mesh):
            clean, rep2 = pir.compile_flat(fn, args, name="drill_shard",
                                           input_shardings=specs)
            out2 = float(clean(*args)[0])
        _expect(rep2.fallback is None,
                f"still degraded after fault cleared: {rep2.fallback}")
        _expect(rep2.pass_report["shard_prop"]["edits"] > 0,
                "clean retry was not sharded")
        _expect(abs(out2 - want) < 1e-5, f"clean recompile wrong: {out2}")
    finally:
        _flags.set_flags({"compile_cache_dir": prev})
    return "degraded", ("shard_prop fault ran that function as written "
                        "(correct numerics, stage=passes counted); the "
                        "clean retry propagated the shardings")


SCENARIOS = {
    "ckpt.chunk_write": drill_ckpt_chunk_write,
    "ckpt.metadata_replace": drill_ckpt_metadata_replace,
    "store.get": drill_store_get,
    "store.set": drill_store_set,
    "elastic.heartbeat": drill_elastic_heartbeat,
    "serve.admit": drill_serve_admit,
    "serve.decode_oom": drill_serve_decode_oom,
    "serve.prefill_chunk": drill_serve_prefill_chunk,
    "serve.hostsync_read": drill_serve_hostsync_read,
    "serve.draft_verify": drill_serve_draft_verify,
    "serve.kv_dequant": drill_serve_kv_dequant,
    "serve.prefix_match": drill_serve_prefix_match,
    "serve.loadgen_tick": drill_serve_loadgen_tick,
    "serve.sched_decide": drill_serve_sched_decide,
    "serve.preempt": drill_serve_preempt,
    "serve.adapter_load": drill_serve_adapter_load,
    "serve.adapter_gather": drill_serve_adapter_gather,
    "train.step_nonfinite": drill_train_step_nonfinite,
    "mesh.route": drill_mesh_route,
    "mesh.kv_handoff": drill_mesh_kv_handoff,
    "mesh.replica_down": drill_mesh_replica_down,
    "mesh.transport_send": drill_mesh_transport_send,
    "mesh.net_delay": drill_mesh_net_delay,
    "mesh.net_stall": drill_mesh_net_stall,
    "mesh.controller_act": drill_mesh_controller_act,
    "obs.sample": drill_obs_sample,
    "compile.cache_read": drill_compile_cache_read,
    "compile.cache_write": drill_compile_cache_write,
    "compile.verify": drill_compile_verify,
    "compile.fuse": drill_compile_fuse,
    "compile.shard_prop": drill_compile_shard_prop,
}


def run(sites=None, device="cuda", verbose=False):
    """Drill `sites` (every scenario when None) with the tiny engines on
    `device`. Returns (rows, problems): rows of (site, outcome, note) in
    site order (a site in NOT_DRILLED as NOT_DRILLED_WHY), and the list of
    what fails the drill."""
    global DEVICE
    DEVICE = device
    problems = []
    missing = sorted(set(faults.FAULT_SITES) - set(SCENARIOS)
                     - set(NOT_DRILLED))
    if missing:
        problems.append(f"sites with no drill scenario: {missing}")
    todo = sorted(SCENARIOS) if sites is None else list(sites)
    obs.enable()
    rec = obs.get_recorder()
    rows = []
    for site in todo:
        fn = SCENARIOS.get(site)
        if fn is None:
            raise KeyError(f"unknown site {site!r}; registered: "
                           f"{sorted(SCENARIOS)}")
        tmp = tempfile.mkdtemp(prefix=f"chaos_{site.replace('.', '_')}_")
        rec.clear()     # per-scenario black box
        fired0 = _counter("fault_injected_total", site=site)
        try:
            outcome, note = fn(tmp)
            if _counter("fault_injected_total", site=site) <= fired0:
                outcome, note = "ESCAPED", (
                    f"fault_injected_total{{site={site}}} did not move")
        except Escape as e:
            outcome, note = "ESCAPED", str(e)
        except Exception as e:  # noqa: BLE001 — the escape we hunt
            outcome, note = "ESCAPED", f"unhandled {type(e).__name__}: {e}"
            if verbose:
                traceback.print_exc()
        finally:
            faults.disarm()
        # black-box gate: EVERY drilled fault must leave a readable,
        # schema-valid flight-recorder dump containing its fault event —
        # a postmortem that can't be read is itself a drill failure
        dump_path = os.path.join(tmp, "flight.json")
        try:
            rec.dump(dump_path, reason=f"drill:{site}")
            doc = flight.validate_dump(dump_path)
            if not any(ev["kind"] == "fault" and ev.get("site") == site
                       for ev in doc["events"]):
                raise ValueError(
                    f"dump has no fault event for site {site!r}")
        except Exception as e:  # noqa: BLE001 — missing/corrupt dump
            problems.append(f"{site}: flight dump bad: {e}")
            note += f" [FLIGHT DUMP BAD: {e}]"
        else:
            if verbose:
                note += f" [flight dump ok: {dump_path}]"
        if outcome == "ESCAPED":
            problems.append(f"{site}: ESCAPED: {note}")
        rows.append((site, outcome, note))
    if sites is None:
        rows += [(site, "-", NOT_DRILLED_WHY) for site in NOT_DRILLED]
        rows.sort()
    return rows, problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--site", action="append",
                    help="drill only this site (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="where the tiny engines run: cuda (default) or cpu")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    unknown = [s for s in args.site or () if s not in SCENARIOS]
    if unknown:
        print(f"unknown or undrilled site(s) {unknown}; drilled: "
              f"{sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    rows, problems = run(args.site, args.device, args.verbose)

    w = max(len(s) for s, _, _ in rows)
    print(f"\n{'site'.ljust(w)}  outcome    note")
    print("-" * (w + 60))
    for site, outcome, note in rows:
        print(f"{site.ljust(w)}  {outcome:<9}  "
              f"{note if args.verbose else note[:70]}")
    fam = obs.get_registry().get("fault_injected_total")
    total_inj = (0 if fam is None
                 else sum(c.value for c in fam.children().values()))
    drilled = [r for r in rows if r[1] != "-"]
    escapes = sum(r[1] == "ESCAPED" for r in drilled)
    print(f"\n{len(drilled)} scenarios on {args.device}, {int(total_inj)} "
          f"faults injected, {escapes} escapes, "
          f"{len(rows) - len(drilled)} sites not drilled")
    if problems:
        for p in problems:
            print(f"DRILL FAILED: {p}", file=sys.stderr)
        return 1
    print("DRILL PASSED: every injected fault was retried, degraded, or "
          "surfaced typed + counted, and left a readable flight dump")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headroom-aware request router for the disaggregated serving mesh.

The MeshRouter fronts a ReplicaPool with the same duck-type surface the
load harness drives a single engine through (add_request / step /
has_work / finished / predicted_service_seconds / predicted_costs), so
`loadgen.run_scenario(router, ...)` works unchanged — the mesh IS an
engine from the harness's point of view.

Routing: requests queue at the router and place onto replicas in DRR
order when an SLOScheduler is attached (the scheduler's priority/tenant
machinery over a mesh-wide admission view), FIFO otherwise. Replica
choice ranks candidates by exported slo_headroom (1 - offered rate x
predicted_service_seconds, per replica) with queue/lane load as the
uncalibrated tiebreaker; every pick passes the `mesh.route` fault site
and the target's CircuitBreaker — a fault or open breaker fails the
pick over to the next-best replica and counts a failover.

Disaggregation: prefill-role replicas carry a prefill_sink, so a
routed request prefills there, exports its paged-KV blocks, and the
router delivers the serialized record to a decode replica
(handoff.hand_off -> import_kv) with retry-then-re-prefill semantics.
The transfer is host bytes between engine steps, overlapped with the
decode replica's in-flight double-buffered tiles.

Correctness contract: tokens commit to the mesh result AT MOST ONCE per
stream — a stream is committed only when it finishes on some replica,
and a mesh request is never committed twice (kill a replica mid-decode
and the re-routed re-prefill regenerates the same stream: greedy decode
is deterministic, sampled lanes key the device PRNG on (seed, absolute
position)). Greedy mesh streams are byte-identical to a single-replica
run.

Gray failure: slowness and death are distinct signals. A
HealthDetector (health.py) scores every replica's progress per pump —
a busy replica whose counters stop moving accrues phi-style suspicion,
trips SLOW (demoted out of `_ranked`, no new placements, counted) and
only past a much larger threshold DEAD (the existing replica_down
path). Placements that outlive a latency budget (quantile of observed
service via THE shared estimator) are HEDGED: a speculative duplicate
starts on the next-best replica, first finish wins through the same
at-most-once commit map, and the loser is withdrawn (engine.cancel).
Streams parked mid-handoff past their deadline_s finish reason=timeout
here — the one place that can see them (neither engine holds the
stream while its bytes are on the wire).

Simulated-parallel clock: replicas are in-process workers stepped
round-robin, so real wall time is serial. Each pump records every
replica's step wall; `sim_parallel_wall_s` sums the per-round MAXIMUM —
the wall clock N separate chips stepping concurrently would see — and
is labeled as simulated wherever it is reported (bench scaling row).

Port: a copy of paddle_tpu/inference/mesh/router.py, which imports no
JAX; its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import time
from collections import deque

from ...observability.autoscale import AutoscaleAdvisor
from ...observability.catalog import metric as _metric
from ...observability.federation import MeshCollector
from ...observability.metrics import get_registry as _get_registry
from ...observability.recorder import get_recorder as _get_recorder
from ...observability.tracing import get_tracer as _get_tracer
from ...observability.tracing import new_trace_id as _new_trace_id
from ...resilience.faults import FaultInjected, check, fault_point
from ...resilience.retry import RetryPolicy
from ..prefix_cache import affinity_key
from ..serving import BackpressureError
from ..scheduler import PRIORITY_CLASSES
from .handoff import KVHandoffError, hand_off_async
from .health import HealthDetector, LatencyBudget

__all__ = ["MeshRequest", "MeshRouter"]

_TRANSIENT = (TimeoutError, ConnectionError, OSError, FaultInjected)

# prefix-affinity hint bounds: remembered first-chunk hashes (FIFO
# evicted past the cap) and how much extra backlog the remembered
# replica may carry versus the best-ranked candidate before load
# balance wins over cache warmth
_AFFINITY_CAP = 512
_AFFINITY_SLACK = 2


class MeshRequest:
    """One stream tracked mesh-wide: the original admission parameters
    (identity survives re-routing: trace id, sampling seed, arrival
    anchor) plus routing state. Doubles as the finished record for
    requests that never reach a replica (router-side timeout), so it
    carries the same reporting fields a serving Request does."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "do_sample", "temperature", "top_k", "top_p", "seed",
                 "deadline_s", "tenant", "priority", "trace_id",
                 "t_arrival", "t_deadline", "t_first", "generated",
                 "done", "finish_reason", "phase", "replica",
                 "local_rid", "hops", "force_local", "t_placed",
                 "hedges", "adapter")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id,
                 do_sample, temperature, top_k, top_p, seed, deadline_s,
                 tenant, priority, adapter=None):
        import numpy as np
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = seed
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.tenant = str(tenant) if tenant else "-"
        self.priority = priority
        self.trace_id = _new_trace_id("req-")
        self.t_arrival = time.perf_counter()
        self.t_deadline = (None if self.deadline_s is None
                           else self.t_arrival + self.deadline_s)
        self.t_first = None
        self.generated = []
        self.done = False
        self.finish_reason = None
        self.phase = "queued"       # queued -> placed -> handoff -> done
        self.replica = None
        self.local_rid = None
        self.hops = 0               # times routed (1 = no failover)
        self.force_local = False    # re-prefill fallback: serve fully
                                    # on a decode replica, no handoff
        self.t_placed = None        # when the live placement started
        self.hedges = []            # speculative duplicate placements:
                                    # [(replica name, local rid), ...]
        self.adapter = str(adapter) if adapter else None


class _AdmissionView:
    """The mesh-wide facade SLOScheduler.pick_index walks: the router's
    front queue plus every alive replica's lanes and parked requests,
    so tenant lane quotas count cluster-wide occupancy."""

    __slots__ = ("queue", "lanes", "_preempted")

    def __init__(self, router):
        self.queue = router.queue
        self.lanes = []
        self._preempted = {}
        for rep in router.pool.alive():
            self.lanes.extend(rep.engine.lanes)
            self._preempted.update(rep.engine._preempted)


class MeshRouter:
    """router = MeshRouter(ReplicaPool(build_engine, n=2))
    rid = router.add_request(prompt, max_new_tokens=16)
    streams = router.run()          # {mesh rid: [tokens]}
    """

    def __init__(self, pool, scheduler=None, max_queue=None,
                 handoff_retry=None, collector="auto", advisor=None,
                 health="auto", hedge_budget_s="auto"):
        self.pool = pool
        self.scheduler = scheduler  # admission ORDER only (DRR pick);
                                    # per-replica brownout stays on the
                                    # replicas' own schedulers
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queue: deque[MeshRequest] = deque()
        self.finished: dict[int, object] = {}   # mesh rid -> Request-like
        self._next_rid = 0
        self._open: dict[int, MeshRequest] = {}
        self._by_trace: dict[str, MeshRequest] = {}
        # (replica name, local rid) -> MeshRequest: the commit map the
        # harvest walks; first finish wins (at-most-once commit)
        self._local: dict[tuple[str, int], MeshRequest] = {}
        self._handoff_q: deque[dict] = deque()
        # in-flight asynchronous deliveries: (future, record, replica
        # name, names already tried) — the decode side parks the stream
        # only on delivery-complete; until then the pump keeps running
        self._pending_handoffs: list[tuple] = []
        # a MeshController (controller.py) acts on autoscale
        # verdicts when attached; None keeps the advisor advisory-only
        self.controller = None
        self._retry = handoff_retry if handoff_retry is not None else \
            RetryPolicy(max_attempts=3, base_delay=0.001, max_delay=0.01,
                        seed=0, sleep=lambda _s: None)
        self._handoffs = {"ok": 0, "retried": 0, "re_prefill": 0,
                          "bytes": 0}
        # prefix-affinity hint — first-prompt-chunk hash ->
        # replica that last served it, so requests sharing a system
        # prompt land where the prefix index is already warm. A HINT
        # only: consulted when the remembered replica is a live
        # candidate whose backlog is within _AFFINITY_SLACK of the
        # best-ranked one; bounded FIFO map, never a correctness input.
        self._affinity: dict[bytes, str] = {}
        self._affinity_bs = int(pool[0].engine.pool.block_size)
        self._failovers: dict[str, int] = {}
        # gray-failure machinery. The detector scores every
        # replica's progress each pump (SLOW names sit in _slow and are
        # demoted from _ranked); the LatencyBudget turns observed
        # placed->commit service into the hedging trigger.
        # health: "auto" -> HealthDetector(), None -> off, or a
        # preconfigured detector (drills tighten its thresholds).
        # hedge_budget_s: "auto" -> quantile budget, None -> hedging
        # off, float -> fixed budget (tests pin it).
        self.health = HealthDetector() if health == "auto" else health
        self._slow: set[str] = set()
        self._hedge_budget_s = hedge_budget_s
        self._service = LatencyBudget()
        self._arrivals: deque[float] = deque(maxlen=256)
        self._t0 = time.perf_counter()
        self.sim_parallel_wall_s = 0.0
        self.serial_wall_s = 0.0
        self.rounds = 0
        self._rec = _get_recorder()
        self._tracer = _get_tracer()
        # bind export sinks on the prefill workers (disaggregated pools
        # only; "both"-role replicas serve locally end to end)
        if pool.disaggregate:
            for rep in pool:
                if rep.role == "prefill":
                    rep.engine.prefill_sink = self._sink
        self.embed_w = pool[0].engine.embed_w
        # the mesh observability plane. "auto" attaches a
        # MeshCollector only when the observability layer is on, so a
        # disabled-plane mesh (most tests, chaos drills) pays nothing —
        # the drilled no-op contract. The advisor turns the collector's
        # recording rules into the autoscale verdict mesh_report() emits.
        if collector == "auto":
            collector = (MeshCollector(pool)
                         if _get_registry().enabled else None)
        self.collector = collector
        self.advisor = advisor if advisor is not None else (
            AutoscaleAdvisor() if collector is not None else None)
        self._autoscale_verdict = None

    # --- harness-facing engine surface -----------------------------------
    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                    seed=0, deadline_s=None, tenant="-",
                    priority="interactive", adapter=None):
        """Queue a request at the mesh front door. Same contract as the
        engine's add_request (priority registry, BackpressureError at
        max_queue); returns the MESH rid."""
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {priority!r}; registered: "
                f"{list(PRIORITY_CLASSES)}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            _metric("serving_backpressure_total").inc()
            raise BackpressureError(
                f"mesh front queue full ({len(self.queue)}/"
                f"{self.max_queue}); retry later")
        rid = self._next_rid
        self._next_rid += 1
        mreq = MeshRequest(rid, prompt, max_new_tokens, eos_token_id,
                           do_sample, temperature, top_k, top_p, seed,
                           deadline_s, tenant, priority, adapter=adapter)
        self.queue.append(mreq)
        self._open[rid] = mreq
        self._by_trace[mreq.trace_id] = mreq
        self._arrivals.append(mreq.t_arrival)
        return rid

    def has_work(self):
        return bool(self.queue or self._handoff_q
                    or self._pending_handoffs
                    or any(not m.done for m in self._open.values()))

    def step(self):
        """One mesh pump: membership beat + kill checks, failover of
        dead replicas' streams, routing, one step per alive replica
        (per-round max wall feeds the simulated-parallel clock),
        handoff delivery, and the commit harvest."""
        self.pool.beat()
        # behavioral kill site: the chaos drill arms mesh.replica_down
        # and the Nth pump loses a worker, exactly like a process kill
        if check("mesh.replica_down") and len(self.pool.alive()) > 1:
            self.kill_replica(self.pool.alive()[0].name, why="injected")
        self._expire_queued()
        self._failover_dead()
        self._route()
        dts = [rep.step() for rep in self.pool.alive()]
        busy = [dt for dt in dts if dt > 0.0]
        if busy:
            self.sim_parallel_wall_s += max(busy)
            self.serial_wall_s += sum(busy)
            self.rounds += 1
        self._observe_health()
        self._pump_handoffs()
        self._maybe_hedge()
        self._harvest()
        if self.collector is not None:
            # sample the plane LAST so the tick sees this pump's state;
            # a collector failure degrades the plane, never the pump
            self.collector.tick()
            if self.advisor is not None:
                self._autoscale_verdict = self._advise()
        if self.controller is not None:
            # the controller acts AFTER harvest so its idle/drained
            # reads are stable; any failure latches it advisory-only
            self.controller.act(self._autoscale_verdict)

    def run(self, max_steps=10_000):
        """Drive to completion; {mesh rid: [tokens]}."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return {rid: list(r.generated)
                for rid, r in sorted(self.finished.items())}

    def predicted_service_seconds(self, output_tokens=32):
        """Mesh-level capacity: mean per-replica calibrated service
        seconds divided by the number of alive replicas that could take
        the work — N workers serve N requests in one replica's time.
        None until at least one replica's cost model calibrates."""
        reps = self.pool.alive()
        ts = [t for t in (rep.engine.predicted_service_seconds(
            output_tokens=output_tokens) for rep in reps)
            if t is not None]
        if not ts:
            return None
        return (sum(ts) / len(ts)) / max(1, len(reps))

    def predicted_costs(self):
        """Per-replica program costs, replica-prefixed."""
        out = {}
        for rep in self.pool.alive():
            for key, cost in rep.engine.predicted_costs().items():
                out[f"{rep.name}:{key}"] = cost
        return out

    # --- routing ---------------------------------------------------------
    def _offered_rate(self):
        now = time.perf_counter()
        win = 0.5
        recent = sum(1 for t in self._arrivals if t > now - win)
        return recent / win

    def _ranked(self, reps):
        """Candidates best-first: lightest observed backlog (queued +
        occupied + parked — immune to cost-model noise, guarantees
        balance across identical replicas), then predicted time-to-
        drain (calibrated service seconds x backlog; uncalibrated
        replicas priced at the calibrated mean, 1s cold, so new workers
        still draw traffic and calibrate), then name. The slo_headroom
        gauge (1 - offered rate x svc) is exported per pick."""
        # controller scale-down victims and SLOW-demoted (health
        # detector) replicas take no NEW work — unless they are all
        # that's left (hint, never a wall)
        active = ([r for r in reps
                   if not r.draining and r.name not in self._slow]
                  or [r for r in reps if not r.draining] or reps)
        rate = self._offered_rate() / max(1, len(active))
        svcs = {rep: rep.engine.predicted_service_seconds()
                for rep in active}
        known = [s for s in svcs.values() if s is not None]
        fallback = sum(known) / len(known) if known else 1.0
        scored = []
        for rep in active:
            svc = svcs[rep]
            if svc is not None:
                _metric("mesh_replica_headroom",
                        replica=rep.name).set(1.0 - rate * svc)
            drain = (svc if svc is not None else fallback) \
                * (rep.load() + 1)
            scored.append((rep, drain))
        # browned-out replicas demote between load and drain-time: a
        # routing HINT (deterministic tiebreak), never a correctness
        # input — a fully browned-out pool still serves everywhere
        return [rep for rep, _d in sorted(
            scored, key=lambda t: (t[0].load(), t[0].brownout_level(),
                                   t[1], t[0].name))]

    def _failover(self, reason, mreq=None):
        self._failovers[reason] = self._failovers.get(reason, 0) + 1
        _metric("mesh_failovers_total", reason=reason).inc()
        if self._rec.enabled:
            self._rec.record("mesh", action="failover", reason=reason,
                             trace=None if mreq is None else mreq.trace_id)

    @staticmethod
    def _adapter_capable(rep, adapter):
        """Placement gate for adapter-bound requests: the replica's
        store must know the name (resident or hot-loadable). A replica
        whose engine is not introspectable — a process-transport proxy —
        is assumed capable; its own admission rejects typed if not."""
        if not adapter:
            return True
        try:
            store = getattr(rep.engine, "adapters", None)
        except Exception:  # noqa: BLE001 — proxy attribute access
            return True
        if store is None or not hasattr(store, "can_serve"):
            # storeless engines reject typed at admission; proxies that
            # hide the attribute are assumed capable
            return not hasattr(rep.engine, "lanes")
        return bool(store.can_serve(adapter))

    def _place(self, mreq):
        """Try to place one mesh request on a replica; True on success.
        Targets the prefill pool for disaggregated requests, the decode
        pool for re-prefill fallbacks, everything alive otherwise."""
        if self.pool.disaggregate and not mreq.force_local:
            cands = self.pool.prefill_targets() or self.pool.decode_targets()
        elif mreq.force_local:
            # re-prefill fallback: a decode replica serves the stream
            # end to end (role is routing policy; every worker can)
            cands = self.pool.decode_targets() or self.pool.alive()
        else:
            cands = self.pool.alive()
        ranked = self._ranked(cands)
        akey = affinity_key("mesh", self._affinity_bs, mreq.prompt)
        if akey is not None and len(ranked) > 1:
            hint = self._affinity.get(akey)
            if hint is not None:
                pref = next((r for r in ranked if r.name == hint), None)
                if (pref is not None and pref is not ranked[0]
                        and pref.load()
                        <= ranked[0].load() + _AFFINITY_SLACK):
                    ranked.remove(pref)
                    ranked.insert(0, pref)
        if mreq.adapter and ranked and not any(
                self._adapter_capable(r, mreq.adapter) for r in ranked):
            # NO alive replica can serve the adapter: typed mesh-level
            # rejection now beats spinning the front queue forever
            self._failover("adapter_missing", mreq)
            _metric("serving_rejected_total", reason="adapter").inc()
            self._commit(mreq, mreq, "rejected")
            return True
        for rep in ranked:
            if not self._adapter_capable(rep, mreq.adapter):
                # adapter affinity: never place on a replica whose store
                # cannot hot-load the name — admission there would only
                # burn a typed rejection. Counted like any other skip.
                self._failover("adapter_missing", mreq)
                continue
            if not rep.breaker.allow():
                self._failover("circuit_open", mreq)
                continue
            try:
                fault_point("mesh.route", rid=mreq.rid, replica=rep.name)
            except _TRANSIENT:
                rep.breaker.record_failure()
                self._failover("route_fault", mreq)
                continue
            try:
                # adapter kwarg only when set: storeless process workers
                # keep their unextended call frame on the wire
                akw = ({"adapter": mreq.adapter} if mreq.adapter else {})
                local_rid = rep.engine.add_request(
                    mreq.prompt, max_new_tokens=mreq.max_new_tokens,
                    eos_token_id=mreq.eos_token_id,
                    do_sample=mreq.do_sample,
                    temperature=mreq.temperature, top_k=mreq.top_k,
                    top_p=mreq.top_p, seed=mreq.seed,
                    deadline_s=mreq.deadline_s, tenant=mreq.tenant,
                    priority=mreq.priority, **akw)
            except BackpressureError:
                self._failover("admit_failed", mreq)
                continue
            rep.breaker.record_success()
            # the replica-local Request adopts the mesh identity so
            # spans, exemplars, and the handoff all join one trace, and
            # TTFT/deadlines stay anchored at TRUE arrival — a framed
            # call for process workers, the same method in-process
            rep.engine.adopt_identity(local_rid, mreq.trace_id,
                                      mreq.t_arrival)
            mreq.phase = "placed"
            mreq.replica = rep.name
            mreq.local_rid = local_rid
            mreq.t_placed = time.perf_counter()
            mreq.hops += 1
            rep.routed += 1
            self._local[(rep.name, local_rid)] = mreq
            if akey is not None:
                self._affinity.pop(akey, None)
                self._affinity[akey] = rep.name
                while len(self._affinity) > _AFFINITY_CAP:
                    self._affinity.pop(next(iter(self._affinity)))
            _metric("mesh_routed_total", replica=rep.name).inc()
            if self._rec.enabled:
                self._rec.record("mesh", action="route", rid=mreq.rid,
                                 replica=rep.name, hop=mreq.hops,
                                 trace=mreq.trace_id)
            if self._tracer.enabled:
                self._tracer.add_span(
                    "mesh.route", time.perf_counter_ns(), 0,
                    trace_id=mreq.trace_id,
                    args={"replica": rep.name, "hop": mreq.hops})
            return True
        return False

    def _route(self):
        """Move front-queue requests onto replicas. With a scheduler,
        admission order is its DRR/priority pick over the mesh-wide
        view; a pick that cannot place anywhere stops routing for this
        pump (ordering is preserved, retried next pump)."""
        while self.queue:
            if self.scheduler is not None:
                idx = self.scheduler.pick_index(_AdmissionView(self))
                if idx is None:
                    return
            else:
                idx = 0
            mreq = self.queue[idx]
            if not self._place(mreq):
                return
            del self.queue[idx]

    def _expire_queued(self):
        """Router-side deadline expiry for requests still in the front
        queue (all replicas saturated / breakers open): same degraded
        'timeout' completion the engine gives its own queue. ALSO sweeps
        streams that exist only between replicas — exported records
        waiting delivery (_handoff_q) and parked async handoffs
        (_pending_handoffs): the prefill engine already released them
        and the decode engine has not admitted them, so neither engine's
        own sweep can see them. A late-landing import for an expired
        stream is withdrawn by _poll_pending's done-cleanup, releasing
        the decode side's blocks."""
        now = time.perf_counter()
        if any(m.t_deadline is not None and now >= m.t_deadline
               for m in self.queue):
            kept = deque()
            for mreq in self.queue:
                if mreq.t_deadline is not None and now >= mreq.t_deadline:
                    self._commit(mreq, mreq, "timeout")
                else:
                    kept.append(mreq)
            self.queue = kept
        for record in list(self._handoff_q) + [e[1] for e
                                               in self._pending_handoffs]:
            mreq = self._by_trace.get(record["trace_id"])
            if (mreq is None or mreq.done or mreq.t_deadline is None
                    or now < mreq.t_deadline):
                continue
            _metric("serving_timeouts_total", where="handoff").inc()
            if self._rec.enabled:
                self._rec.record("timeout", rid=mreq.rid, where="handoff")
            self._commit(mreq, mreq, "timeout")

    # --- disaggregated handoff -------------------------------------------
    def _sink(self, record):
        """prefill_sink bound on prefill workers: the exported record
        queues for delivery on the next pump — i.e. while the decode
        replica's in-flight tiles drain, not blocking either engine."""
        self._handoff_q.append(record)

    def _pump_handoffs(self):
        # poll in-flight deliveries FIRST: any transport copy that
        # completed while the decode pump ran parks its stream now
        if self._pending_handoffs:
            pending, self._pending_handoffs = self._pending_handoffs, []
            for entry in pending:
                self._poll_pending(*entry)
        for _ in range(len(self._handoff_q)):
            record = self._handoff_q.popleft()
            self._deliver(record)

    def _deliver(self, record, tried=None):
        mreq = self._by_trace.get(record["trace_id"])
        if mreq is None or mreq.done:
            return
        tried = set() if tried is None else tried
        rejected = bool(tried)
        for rep in self._ranked(self.pool.decode_targets()):
            if rep.name in tried:
                continue
            if not rep.breaker.allow():
                self._failover("circuit_open", mreq)
                continue
            fut = hand_off_async(record, rep.engine, retry=self._retry)
            if not fut.done():
                # delivery in flight: the transport copy overlaps the
                # decode pump; the stream parks only on completion
                mreq.phase = "handoff_pending"
                self._pending_handoffs.append(
                    (fut, record, rep.name, tried, time.perf_counter()))
                if self._rec.enabled:
                    self._rec.record("mesh", action="handoff_async",
                                     replica=rep.name,
                                     trace=mreq.trace_id)
                return
            try:
                local_rid, nbytes, retries = fut.result()
            except KVHandoffError as e:
                if isinstance(e.__cause__, (ValueError, MemoryError)):
                    # THIS target rejected the record (format mismatch /
                    # pool full) — the transfer itself is fine, try the
                    # next-best decode worker
                    rejected = True
                    tried.add(rep.name)
                    continue
                rep.breaker.record_failure()
                break       # transfer failed past the retry budget
            self._handoff_ok(mreq, rep, local_rid, nbytes, retries)
            return
        self._re_prefill(mreq, rejected)

    def _poll_pending(self, fut, record, rname, tried, t0):
        """Progress one in-flight async handoff; unresolved futures go
        back on the pending list, completed ones settle through the
        same classification as the synchronous path."""
        if not fut.done():
            self._pending_handoffs.append((fut, record, rname, tried, t0))
            return
        mreq = self._by_trace.get(record["trace_id"])
        if mreq is None or mreq.done:
            # the stream no longer needs this import (its hedge sibling
            # committed first, or its deadline expired while parked) —
            # if the copy landed anyway, withdraw the duplicate so the
            # decode side's pool blocks release instead of a ghost
            # stream decoding to nowhere
            self._withdraw_import(fut, record, rname, mreq)
            return
        rep = self.pool.by_name(rname)
        if not rep.alive:
            # the target died with the copy in flight — a transfer
            # failure by definition; failover already re-routed nothing
            # (mreq.replica was never set), so re-prefill here
            self._re_prefill(mreq, bool(tried))
            return
        try:
            local_rid, nbytes, retries = fut.result()
        except KVHandoffError as e:
            if isinstance(e.__cause__, (ValueError, MemoryError)):
                tried.add(rname)
                self._deliver(record, tried=tried)
                return
            rep.breaker.record_failure()
            self._re_prefill(mreq, bool(tried))
            return
        self._handoff_ok(mreq, rep, local_rid, nbytes, retries)

    def _handoff_ok(self, mreq, rep, local_rid, nbytes, retries):
        rep.breaker.record_success()
        self._handoffs["ok"] += 1
        self._handoffs["bytes"] += nbytes
        if retries:
            self._handoffs["retried"] += 1
            _metric("mesh_handoffs_total", outcome="retried").inc()
        _metric("mesh_handoffs_total", outcome="ok").inc()
        _metric("mesh_handoff_bytes").observe(nbytes)
        mreq.phase = "handoff"
        mreq.replica = rep.name
        mreq.local_rid = local_rid
        rep.routed += 1
        self._local[(rep.name, local_rid)] = mreq
        if self._rec.enabled:
            self._rec.record("mesh", action="handoff",
                             replica=rep.name, bytes=nbytes,
                             retries=retries, trace=mreq.trace_id)
        if self._tracer.enabled:
            self._tracer.add_span(
                "mesh.handoff", time.perf_counter_ns(), 0,
                trace_id=mreq.trace_id,
                args={"replica": rep.name, "bytes": nbytes})

    def _re_prefill(self, mreq, rejected):
        # retry-then-re-prefill: the serialized blocks never arrived (or
        # no decode worker could hold them) — re-run prefill from the
        # prompt on the decode side. Slower, byte-identical.
        self._handoffs["re_prefill"] += 1
        _metric("mesh_handoffs_total", outcome="re_prefill").inc()
        self._requeue(mreq, front=True, force_local=True)
        if self._rec.enabled:
            self._rec.record("mesh", action="re_prefill",
                             rejected=rejected, trace=mreq.trace_id)

    def _withdraw_import(self, fut, record, rname, mreq):
        """A landed import whose stream is already settled elsewhere:
        cancel it on the decode worker (idempotent server-side; the
        commit map would drop its tokens anyway — this just stops the
        wasted decode and frees the blocks)."""
        try:
            local_rid, _nbytes, _retries = fut.result()
        except Exception:   # noqa: BLE001 — failed delivery, nothing to undo
            return
        rep = self.pool.by_name(rname)
        cancel = getattr(rep.engine, "cancel", None)
        if rep.alive and cancel is not None:
            # map the duplicate into the commit graveyard FIRST: if the
            # cancel races a same-pump finish, harvest still drops it
            if mreq is not None:
                self._local[(rname, local_rid)] = mreq
            try:
                cancel(local_rid)
            except _TRANSIENT:
                pass
        if self._rec.enabled:
            self._rec.record("mesh", action="import_withdrawn",
                             replica=rname, trace=record.get("trace_id"))

    # --- gray failure: progress health + hedged recovery -----------------
    def _observe_health(self):
        """Feed the detector one observation per alive replica and act
        on the verdict: SLOW demotes (reversibly) out of _ranked, DEAD
        walks the existing replica_down path. Progress is the counters
        that only move when the worker actually answers (steps credited,
        streams harvested, tokens committed) — a worker whose step reply
        is parked past its budget reports dt=0 and freezes all three."""
        if self.health is None:
            return
        now = time.perf_counter()
        for rep in self.pool.alive():
            progress = (rep.steps, rep.finished_count, rep.tokens_out)
            busy = bool(rep.engine.has_work())
            verdict, phi = self.health.observe(rep.name, now, busy,
                                               progress)
            _metric("mesh_replica_suspicion", replica=rep.name).set(phi)
            if verdict == "dead" and len(self.pool.alive()) > 1:
                self._slow.discard(rep.name)
                if self._rec.enabled:
                    self._rec.record("mesh", action="health_dead",
                                     replica=rep.name, phi=round(phi, 2))
                self.kill_replica(rep.name, why="health_dead")
            elif verdict != "healthy" and rep.name not in self._slow:
                # "dead" with no survivor also lands here: demote-only
                # (killing the last replica would serve nobody)
                self._slow.add(rep.name)
                _metric("mesh_slow_demotions_total",
                        replica=rep.name).inc()
                if self._rec.enabled:
                    self._rec.record("mesh", action="health_slow",
                                     replica=rep.name, phi=round(phi, 2))
            elif verdict == "healthy" and rep.name in self._slow:
                self._slow.discard(rep.name)
                if self._rec.enabled:
                    self._rec.record("mesh", action="health_recovered",
                                     replica=rep.name)

    def _hedge_budget(self):
        if self._hedge_budget_s == "auto":
            return self._service.budget()    # None until calibrated
        return self._hedge_budget_s          # None = off, float = fixed

    def _maybe_hedge(self):
        """Speculative duplicates for work that outlived the latency
        budget: a parked handoff whose copy never completes, or an
        in-flight placement stuck on a prefill-role or SLOW replica.
        One hedge per stream; first finish wins through the commit map
        (the loser is withdrawn), so greedy streams stay byte-identical
        whether the original or the hedge lands first."""
        budget = self._hedge_budget()
        if budget is None:
            return
        now = time.perf_counter()
        for _fut, record, rname, _tried, t0 in list(self._pending_handoffs):
            if now - t0 <= budget:
                continue
            mreq = self._by_trace.get(record["trace_id"])
            if mreq is None or mreq.done or mreq.hedges:
                continue
            self._launch_hedge(mreq, exclude={rname})
        for mreq in list(self._open.values()):
            if (mreq.done or mreq.hedges or mreq.phase != "placed"
                    or mreq.replica is None or mreq.t_placed is None
                    or now - mreq.t_placed <= budget):
                continue
            try:
                rep = self.pool.by_name(mreq.replica)
            except KeyError:
                continue
            if not rep.alive:
                continue        # _failover_dead owns dead-replica streams
            if rep.role == "prefill" or rep.name in self._slow:
                self._launch_hedge(mreq, exclude={mreq.replica})

    def _launch_hedge(self, mreq, exclude):
        """Place a full-service duplicate (prompt re-prefill, same
        identity) on the best replica not in `exclude`; True when one
        started. The duplicate adopts the same trace so either finish
        commits the same stream."""
        cands = [r for r in self._ranked(self.pool.decode_targets()
                                         or self.pool.alive())
                 if r.name not in exclude
                 and self._adapter_capable(r, mreq.adapter)]
        for rep in cands:
            if not rep.breaker.allow():
                continue
            try:
                akw = ({"adapter": mreq.adapter} if mreq.adapter else {})
                local_rid = rep.engine.add_request(
                    mreq.prompt, max_new_tokens=mreq.max_new_tokens,
                    eos_token_id=mreq.eos_token_id,
                    do_sample=mreq.do_sample,
                    temperature=mreq.temperature, top_k=mreq.top_k,
                    top_p=mreq.top_p, seed=mreq.seed,
                    deadline_s=mreq.deadline_s, tenant=mreq.tenant,
                    priority=mreq.priority, **akw)
            except BackpressureError:
                continue
            rep.engine.adopt_identity(local_rid, mreq.trace_id,
                                      mreq.t_arrival)
            rep.routed += 1
            mreq.hedges.append((rep.name, local_rid))
            self._local[(rep.name, local_rid)] = mreq
            _metric("mesh_hedges_total", outcome="launched").inc()
            if self._rec.enabled:
                self._rec.record("mesh", action="hedge",
                                 replica=rep.name, trace=mreq.trace_id)
            if self._tracer.enabled:
                self._tracer.add_span(
                    "mesh.hedge", time.perf_counter_ns(), 0,
                    trace_id=mreq.trace_id, args={"replica": rep.name})
            return True
        return False

    def _settle_hedges(self, mreq, winner):
        """First finish won: withdraw every losing placement from its
        worker. The _local entries STAY — if a cancel races a finish,
        harvest pops the duplicate and _commit's idempotence drops it
        unread (the original at-most-once contract)."""
        placements = []
        if mreq.replica is not None and mreq.local_rid is not None:
            placements.append((mreq.replica, mreq.local_rid))
        placements.extend(mreq.hedges)
        if winner is not None and winner in mreq.hedges:
            _metric("mesh_hedges_total", outcome="win").inc()
            if self._rec.enabled:
                self._rec.record("mesh", action="hedge_win",
                                 replica=winner[0], trace=mreq.trace_id)
        for key in placements:
            if key == winner:
                continue
            try:
                rep = self.pool.by_name(key[0])
            except KeyError:
                continue
            cancel = getattr(rep.engine, "cancel", None)
            if not rep.alive or cancel is None:
                continue
            try:
                if cancel(key[1]):
                    _metric("mesh_hedges_total",
                            outcome="cancelled").inc()
                    if self._rec.enabled:
                        self._rec.record("mesh", action="hedge_cancel",
                                         replica=key[0],
                                         trace=mreq.trace_id)
            except _TRANSIENT:
                pass

    # --- failover --------------------------------------------------------
    def kill_replica(self, name, why="drill"):
        """Lose a worker: tombstone its lease (pool.kill) and re-route
        every uncommitted stream it held — each re-prefills from its
        prompt on a survivor and regenerates the same tokens."""
        rep = self.pool.by_name(name)
        if not rep.alive:
            return
        self.pool.kill(name)
        self._slow.discard(name)
        if self.health is not None:
            self.health.forget(name)    # a respawn starts clean
        if self._rec.enabled:
            self._rec.record("mesh", action="kill", replica=name, why=why)
        self._failover_dead()

    def _failover_dead(self):
        """Re-route uncommitted streams assigned to dead replicas, and
        drop exported-but-undelivered handoff records that originated
        on one (they lived in the dead process's memory)."""
        dead = {rep.name for rep in self.pool if not rep.alive}
        if not dead:
            return
        moved = set()
        for (rname, _lrid), mreq in list(self._local.items()):
            if (rname in dead and not mreq.done
                    and mreq.replica == rname
                    and mreq.rid not in moved):
                moved.add(mreq.rid)
                self._failover("replica_down", mreq)
                self._requeue(mreq, front=True,
                              force_local=not self.pool.disaggregate
                              or not self.pool.prefill_targets())
        if self._handoff_q:
            survivors = deque()
            for record in self._handoff_q:
                mreq = self._by_trace.get(record["trace_id"])
                if mreq is not None and not mreq.done \
                        and mreq.rid not in moved:
                    survivors.append(record)
            self._handoff_q = survivors

    def _requeue(self, mreq, front=False, force_local=False):
        mreq.phase = "queued"
        mreq.replica = None
        mreq.local_rid = None
        mreq.force_local = force_local or mreq.force_local
        if front:
            self.queue.appendleft(mreq)
        else:
            self.queue.append(mreq)

    # --- commit (at most once per stream) --------------------------------
    def _commit(self, mreq, rec, reason=None, winner=None):
        if mreq.done:
            return
        mreq.done = True
        mreq.phase = "done"
        if rec is mreq:
            mreq.finish_reason = reason
        self.finished[mreq.rid] = rec
        self._open.pop(mreq.rid, None)
        self._by_trace.pop(mreq.trace_id, None)
        if rec is not mreq and mreq.t_placed is not None:
            # real service only (router-side timeouts would poison the
            # quantile the hedging budget is derived from)
            self._service.observe(time.perf_counter() - mreq.t_placed)
        if mreq.hedges:
            self._settle_hedges(mreq, winner)

    def _harvest(self):
        """Pull finished requests off alive replicas into the mesh
        result. A stream commits exactly once: the commit map's first
        finish wins, later duplicates (a re-routed stream whose original
        replica was thought dead, or a hedge's losing sibling) are
        dropped unread."""
        for rep in self.pool.alive():
            eng = rep.engine
            if not eng.finished:
                continue
            for local_rid in list(eng.finished):
                mreq = self._local.get((rep.name, local_rid))
                if mreq is None:
                    continue
                req = eng.finished.pop(local_rid)
                rep.finished_count += 1
                rep.tokens_out += len(req.generated)
                self._commit(mreq, req, winner=(rep.name, local_rid))

    # --- telemetry aggregation -------------------------------------------
    def _advise(self):
        """One deterministic advisory tick: the collector's recording
        rules (headroom min/sum, burn rate) plus the router's own
        backlog and per-replica snapshots for drain predictions.
        Defaults are benign (full headroom, no burn) until the rules
        have the two ticks they need to evaluate."""
        alive = self.pool.alive()
        col = self.collector
        hm = col.latest("headroom_min")
        hs = col.latest("headroom_sum")
        burn = col.latest("slo_burn_rate")
        return self.advisor.advise(
            current_replicas=len(alive),
            headroom_min=1.0 if hm is None else hm,
            headroom_sum=hs,
            burn_rate=0.0 if burn is None else burn,
            backlog=len(self.queue),
            replica_stats={rep.name: rep.snapshot() for rep in alive})

    def mesh_report(self):
        """One mesh-level report: per-replica phase/SLO snapshots plus
        routing, handoff, failover, and simulated-parallel wall
        accounting. `sim_parallel_wall_s` is the concurrent-worker
        clock (per-round max of the in-process replica step walls) —
        simulated, and labeled as such wherever bench reports it."""
        committed_tokens = sum(len(r.generated)
                               for r in self.finished.values())
        sim = self.sim_parallel_wall_s
        report = {
            "replicas": {rep.name: rep.snapshot() for rep in self.pool},
            "membership": self.pool.alive_nodes(),
            "disaggregate": self.pool.disaggregate,
            "routed": sum(rep.routed for rep in self.pool),
            "handoffs": dict(self._handoffs),
            "failovers": dict(self._failovers),
            "slow": sorted(self._slow),
            "suspicion": ({rep.name: round(self.health.suspicion(
                rep.name, time.perf_counter()), 3)
                for rep in self.pool.alive()}
                if self.health is not None else {}),
            "open": sum(1 for m in self._open.values() if not m.done),
            "committed_tokens": committed_tokens,
            "rounds": self.rounds,
            "serial_wall_s": round(self.serial_wall_s, 4),
            "sim_parallel_wall_s": round(sim, 4),
            "sim_parallel": True,
            "sim_tok_per_s": (round(committed_tokens / sim, 1)
                              if sim > 0 else None),
        }
        if self.collector is not None:
            report["timeseries"] = self.collector.summary()
            if self.advisor is not None:
                report["autoscale"] = (self._autoscale_verdict
                                       if self._autoscale_verdict is not None
                                       else self._advise())
        return report

"""Overload-safe SLO scheduler for the continuous-batching engine.

PR 10 landed the sensing half of the SLO loop (seeded loadgen, phase
attribution, the `slo_headroom` / `serving_overload` gauges); this
module is the acting half. It closes the loop with three mechanisms,
each driven by the signals the engine already emits:

  - **priority classes + preemption**: requests carry one of the
    PRIORITY_CLASSES below; when interactive traffic is waiting and the
    engine is under SLO pressure, a batch/best_effort decode lane is
    preempted. The paged-KV blocks stay resident and the host decode
    cursor is parked, so the lane later resumes through the
    membership-change upload path with a byte-identical stream — no
    re-prefill, no re-decode.
  - **per-tenant fairness + quotas**: admission order comes from a
    deficit-round-robin walk over per-tenant sub-queues (keyed by the
    bounded-cardinality tenant label), with an optional per-tenant lane
    quota; a quota'd tenant's requests stay queued and the deferral is
    counted (`serving_quota_deferrals_total{tenant}`).
  - **brownout ladder**: a closed, ordered registry of degradation
    levels (BROWNOUT_LEVELS). TTFT/TPOT observations and the cost-model
    headroom drive one-level-at-a-time escalation and — with hysteresis
    — recovery. Every transition is counted
    (`serving_brownout_transitions_total{direction}`), gauged
    (`serving_brownout_level`), and recorded in the flight recorder.

Failure contract (the `serve.sched_decide` fault site): ANY exception
out of the per-step decision degrades scheduling to plain FIFO for the
engine's lifetime — brownout knobs restored, preempted lanes resumed,
admission back to first-come-first-served. The engine never deadlocks
and never drops a lane because its scheduler broke.

Both registries are **closed**: the static checker's scheduler-actions
rule pins every priority/brownout literal used in serving/scheduler
code to these dicts, and both must match the RESILIENCE.md "Overload
runbook" tables in both directions.

Port: a copy of `paddle_tpu/inference/scheduler.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import time
from collections import deque

from ..observability.catalog import metric as _metric
from ..observability.recorder import get_recorder as _get_recorder
from ..observability.slo import DEFAULT_SLOS
from ..resilience.faults import fault_point

__all__ = ["PRIORITY_CLASSES", "BROWNOUT_LEVELS", "SLOScheduler",
           "level_index", "level_name"]

# Closed registry of request priority classes, ordered by admission
# precedence (first = most latency-sensitive). The dict literal is
# parsed by tools/static_check.py's scheduler-actions rule.
PRIORITY_CLASSES = {
    "interactive": "latency-sensitive user traffic: admitted first, "
                   "never preempted, its TTFT/TPOT drive the ladder",
    "batch": "throughput traffic: admitted after interactive, decode "
             "lanes preemptible under SLO pressure",
    "best_effort": "scavenger traffic: admitted last, preempted first, "
                   "shed outright at the deepest brownout level",
}

# Closed, ORDERED registry of brownout degradation levels. Index order
# IS severity order; each level's actions are cumulative with every
# level above it. All knob changes are reversible on recovery — unlike
# the fault-driven degradations (speculation_off, kv_bf16), which are
# permanent for the engine's lifetime.
BROWNOUT_LEVELS = {
    "normal": "no degradation: base decode_steps/draft_depth, "
              "speculation as configured",
    "shrink_decode_steps": "halve the fused-scan K so occupancy "
                           "changes (admission, preemption) take "
                           "effect with half the dispatch latency",
    "reduce_draft_depth": "drop speculative draft_depth to 1: less "
                          "verify work per dispatch under pressure",
    "disable_speculation": "turn speculation off (reversibly): decode "
                           "reverts to the plain fused program",
    "force_small_prefill_chunk": "plan new admissions' prefill at the "
                                 "smallest compiled chunk width so "
                                 "decode lanes wait behind shorter "
                                 "prefill pieces (reshape, not shed)",
    "cap_max_new_tokens": "clamp newly admitted requests' "
                          "max_new_tokens to the scheduler's mnt_cap: "
                          "shorter streams drain backlog faster; the "
                          "stream still serves (reshape, not shed)",
    "shed_best_effort": "stop serving best_effort: queued best_effort "
                        "requests finish with finish_reason='shed' at "
                        "admission",
}

_LEVEL_ORDER = tuple(BROWNOUT_LEVELS)
MAX_LEVEL = len(_LEVEL_ORDER) - 1

# preemption victim order: higher rank = preempted first
_PRIO_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}


def level_index(name):
    """Index of a brownout level in the closed registry. Raises KeyError
    on an unknown name — the registry is closed, same discipline as the
    metric catalog. String-literal call sites are linted against
    BROWNOUT_LEVELS by the scheduler-actions rule."""
    try:
        return _LEVEL_ORDER.index(name)
    except ValueError:
        raise KeyError(
            f"unknown brownout level {name!r}; registered: "
            f"{list(_LEVEL_ORDER)}") from None


def level_name(idx):
    """Registry name of a brownout level index."""
    return _LEVEL_ORDER[int(idx)]


# ladder rungs referenced by _apply(); resolved once through the closed
# registry so a registry rename cannot silently desynchronize the knobs
_IDX_SHRINK = level_index("shrink_decode_steps")
_IDX_DRAFT = level_index("reduce_draft_depth")
_IDX_NOSPEC = level_index("disable_speculation")
_IDX_SMALL_CHUNK = level_index("force_small_prefill_chunk")
_IDX_CAP_MNT = level_index("cap_max_new_tokens")
_IDX_SHED = level_index("shed_best_effort")


def _pctl(values, q):
    """Deterministic host-side quantile over a small window (sorted
    nearest-rank); None when the window is empty."""
    if not values:
        return None
    s = sorted(values)
    return s[int(q * (len(s) - 1))]


class _Signals:
    """One step's scheduling inputs, separated from the engine so
    `decide()` is unit-testable without a model."""

    __slots__ = ("headroom", "ttft_p95", "tpot_p99", "queued_interactive",
                 "free_lanes")

    def __init__(self, headroom=None, ttft_p95=None, tpot_p99=None,
                 queued_interactive=0, free_lanes=0):
        self.headroom = headroom
        self.ttft_p95 = ttft_p95
        self.tpot_p99 = tpot_p99
        self.queued_interactive = queued_interactive
        self.free_lanes = free_lanes


def _default_target(name):
    spec = next((s for s in DEFAULT_SLOS if s.name == name), None)
    return None if spec is None else float(spec.objective)


class SLOScheduler:
    """Closed-loop admission/preemption/brownout policy for ONE engine.

    The engine calls `on_step(engine)` once per scheduling step (before
    admission), `pick_index(engine)` to choose which queued request to
    admit next, `should_resume(engine)` before re-admitting preempted
    lanes, and feeds TTFT/TPOT observations through `note_ttft` /
    `note_tpot`. All state is host-side and O(tenants + window); the
    scheduler never touches device arrays.

    Knobs:
      ttft_target / tpot_target: seconds; default from DEFAULT_SLOS
        (ttft_p95 / tpot_p99 objectives).
      quantum: DRR credit per tenant visit, in tokens (prompt +
        max_new_tokens is the cost unit — the same unit
        predicted_service_seconds prices).
      tenant_quota: max simultaneously-occupied lanes per tenant
        (None = unlimited).
      adapter_quota: max simultaneously-occupied lanes per NAMED LoRA
        adapter (None = unlimited; base-weight requests are exempt) —
        caps how much of the batch one hot finetune can pin, the same
        way tenant_quota caps a tenant.
      escalate_after / recover_after: consecutive bad/good decisions
        before a level transition (recovery is deliberately slower —
        hysteresis, so the ladder cannot flap).
      min_dwell: steps a level must hold before the NEXT transition.
      resume_margin: headroom above which preempted lanes resume even
        while interactive traffic is still queued.
      window: TTFT/TPOT observation window (per-signal deque length).
      rate_window_s: trailing window for the offered-arrival-rate
        estimate that feeds headroom.
      mnt_cap: max_new_tokens clamp applied to admissions while the
        cap_max_new_tokens rung is engaged (reshape, not shed).
    """

    def __init__(self, ttft_target=None, tpot_target=None, quantum=32.0,
                 tenant_quota=None, adapter_quota=None, escalate_after=2,
                 recover_after=4, min_dwell=2, resume_margin=0.25,
                 window=128, rate_window_s=0.5, mnt_cap=16):
        self.ttft_target = (float(ttft_target) if ttft_target is not None
                            else _default_target("ttft_p95"))
        self.tpot_target = (float(tpot_target) if tpot_target is not None
                            else _default_target("tpot_p99"))
        self.quantum = float(quantum)
        self.tenant_quota = (None if tenant_quota is None
                             else max(1, int(tenant_quota)))
        self.adapter_quota = (None if adapter_quota is None
                              else max(1, int(adapter_quota)))
        self.escalate_after = max(1, int(escalate_after))
        self.recover_after = max(1, int(recover_after))
        self.min_dwell = max(0, int(min_dwell))
        self.resume_margin = float(resume_margin)
        self.rate_window_s = float(rate_window_s)
        self.mnt_cap = max(1, int(mnt_cap))
        self.level = 0
        self.fifo = False           # True after a sched_decide failure
        self.shed_best_effort = False
        self.transitions_up = 0
        self.transitions_down = 0
        self.preempt_requests = 0
        self._ttft = deque(maxlen=int(window))
        self._tpot = deque(maxlen=int(window))
        self._bad = 0               # consecutive bad decisions
        self._good = 0              # consecutive good decisions
        self._dwell = self.min_dwell    # steps since last transition
        self._last_sig = None
        # DRR state: per-priority-class tenant ring + cursor, and a
        # (class, tenant) -> residual-credit map
        self._rings: dict[str, list[str]] = {}
        self._cursors: dict[str, int] = {}
        self._deficit: dict[tuple[str, str], float] = {}
        self._rec = _get_recorder()
        self._m_level = _metric("serving_brownout_level")
        self._m_level.set(float(self.level))

    # --- signal intake ---------------------------------------------------
    def note_ttft(self, seconds):
        self._ttft.append(float(seconds))

    def note_tpot(self, seconds):
        self._tpot.append(float(seconds))

    # --- the per-step decision -------------------------------------------
    def on_step(self, engine):
        """One closed-loop decision: collect signals, move the brownout
        ladder at most one level, and preempt at most one lane. ANY
        failure — including the serve.sched_decide fault site — degrades
        this scheduler to plain FIFO for the engine's lifetime; overload
        can break the policy, never the engine."""
        if self.fifo:
            return
        try:
            fault_point("serve.sched_decide", level=self.level)
            sig = self._collect(engine)
            self._last_sig = sig
            if self.decide(sig):
                self._apply(engine)
            self._maybe_preempt(engine, sig)
        except Exception as e:  # noqa: BLE001 — FIFO degrade, no deadlock
            self._degrade_fifo(engine, why=type(e).__name__)

    def _collect(self, engine):
        """Engine state -> _Signals. Headroom uses the engine's own
        trailing arrival rate (so the scheduler works without loadgen)
        against the calibrated cost model; TTFT/TPOT windows are fed by
        the engine's note_* hooks."""
        now = time.perf_counter()
        cutoff = now - self.rate_window_s
        recent = sum(1 for t in engine._arrivals if t > cutoff)
        svc = engine.predicted_service_seconds()
        headroom = None
        if svc is not None and recent:
            headroom = 1.0 - (recent / self.rate_window_s) * svc
        return _Signals(
            headroom=headroom,
            ttft_p95=_pctl(self._ttft, 0.95),
            tpot_p99=_pctl(self._tpot, 0.99),
            queued_interactive=sum(
                1 for r in engine.queue if r.priority == "interactive"),
            free_lanes=sum(1 for r in engine.lanes if r is None))

    def decide(self, sig):
        """Move the ladder at most ONE level for this step's signals.
        Escalation needs `escalate_after` consecutive bad steps,
        recovery `recover_after` consecutive good ones, and every
        transition starts a `min_dwell` cooldown — monotone one-rung
        moves with hysteresis, no flapping. Returns True when the level
        changed (caller re-applies the knobs)."""
        bad = ((sig.headroom is not None and sig.headroom <= 0.0)
               or (sig.ttft_p95 is not None
                   and self.ttft_target is not None
                   and sig.ttft_p95 > self.ttft_target)
               or (sig.tpot_p99 is not None
                   and self.tpot_target is not None
                   and sig.tpot_p99 > self.tpot_target))
        self._dwell += 1
        if bad:
            self._bad += 1
            self._good = 0
            if (self._bad >= self.escalate_after and self.level < MAX_LEVEL
                    and self._dwell > self.min_dwell):
                self._transition(self.level + 1, "up")
                return True
        else:
            self._good += 1
            self._bad = 0
            if (self._good >= self.recover_after and self.level > 0
                    and self._dwell > self.min_dwell):
                self._transition(self.level - 1, "down")
                return True
        return False

    def _transition(self, new_level, direction):
        self.level = int(new_level)
        self._dwell = 0
        self._bad = 0
        self._good = 0
        if direction == "up":
            self.transitions_up += 1
        else:
            self.transitions_down += 1
        _metric("serving_brownout_transitions_total",
                direction=direction).inc()
        self._m_level.set(float(self.level))
        if self._rec.enabled:
            self._rec.record("sched", action="brownout",
                             direction=direction, level=self.level,
                             name=level_name(self.level))

    def _apply(self, engine):
        """Re-derive every brownout knob from the current level —
        cumulative and REVERSIBLE: level 0 restores the engine's
        constructor-time base values (modulo permanent fault
        degradations, which the engine's setters respect)."""
        lvl = self.level
        base_k = engine._base_decode_steps
        engine._set_decode_steps(
            max(1, base_k // 2) if lvl >= _IDX_SHRINK else base_k)
        engine._set_draft_depth(
            1 if lvl >= _IDX_DRAFT else engine._base_draft_depth)
        engine._set_speculation(lvl < _IDX_NOSPEC)
        engine._set_prefill_chunk_small(lvl >= _IDX_SMALL_CHUNK)
        engine._set_mnt_cap(self.mnt_cap if lvl >= _IDX_CAP_MNT else None)
        self.shed_best_effort = lvl >= _IDX_SHED

    # --- preemption ------------------------------------------------------
    def _maybe_preempt(self, engine, sig):
        """Preempt at most one non-interactive decode lane per step,
        only when interactive traffic is actually waiting, no lane is
        free, and the engine is under pressure (non-positive headroom, a
        TTFT breach, or an already-engaged ladder)."""
        if not sig.queued_interactive or sig.free_lanes:
            return
        pressure = ((sig.headroom is not None and sig.headroom <= 0.0)
                    or (sig.ttft_p95 is not None
                        and self.ttft_target is not None
                        and sig.ttft_p95 > self.ttft_target)
                    or self.level > 0)
        if not pressure:
            return
        victims = [i for i in engine._decode_active()
                   if engine.lanes[i].priority != "interactive"]
        if not victims:
            return
        # preempt the lowest class first; among equals, the lane with
        # the most remaining work (it blocks the lane longest)
        victim = max(victims, key=lambda i: (
            _PRIO_RANK[engine.lanes[i].priority],
            engine.lanes[i].max_new_tokens
            - len(engine.lanes[i].generated), -i))
        if engine._try_preempt(victim, why="slo_pressure"):
            self.preempt_requests += 1

    def should_resume(self, engine):
        """Whether parked (preempted) requests may re-enter lanes this
        step: always once degraded to FIFO, when no interactive request
        is waiting for the lane, or when headroom has recovered past the
        resume margin."""
        if self.fifo:
            return True
        if not any(r.priority == "interactive" for r in engine.queue):
            return True
        sig = self._last_sig
        return (sig is not None and sig.headroom is not None
                and sig.headroom > self.resume_margin)

    # --- admission order: deficit round robin over tenants ---------------
    def _cost(self, req):
        # total sequence footprint in tokens — the same unit the pool
        # reserves and predicted_service_seconds prices
        return float(req.prompt.size + req.max_new_tokens)

    def pick_index(self, engine):
        """Index into engine.queue of the next request to admit, or None
        to admit nothing this step. Priority classes strictly dominate;
        within a class, tenants are served deficit-round-robin (each
        ring visit earns `quantum` tokens of credit; serving a request
        spends its footprint), so one tenant's flood of long prompts
        cannot starve another's short ones. Tenants at their lane quota
        are skipped and the deferral counted. The walk is bounded and
        falls back to the class's first queued request, so admission
        always makes progress."""
        queue = engine.queue
        if not queue:
            return None
        if self.fifo:
            return 0
        lanes_per_tenant: dict[str, int] = {}
        lanes_per_adapter: dict[str, int] = {}
        for r in engine.lanes:
            if r is not None:
                lanes_per_tenant[r.tenant] = \
                    lanes_per_tenant.get(r.tenant, 0) + 1
                if r.adapter:
                    lanes_per_adapter[r.adapter] = \
                        lanes_per_adapter.get(r.adapter, 0) + 1
        for _, (req, _ln, _tok) in engine._preempted.items():
            lanes_per_tenant[req.tenant] = \
                lanes_per_tenant.get(req.tenant, 0) + 1
            if req.adapter:
                lanes_per_adapter[req.adapter] = \
                    lanes_per_adapter.get(req.adapter, 0) + 1
        deferred: set[str] = set()
        deferred_ad: set[str] = set()
        for cls in PRIORITY_CLASSES:
            heads: dict[str, int] = {}     # tenant -> queue index of head
            for i, r in enumerate(queue):
                if r.priority != cls or r.tenant in heads:
                    continue
                if (self.tenant_quota is not None
                        and lanes_per_tenant.get(r.tenant, 0)
                        >= self.tenant_quota):
                    if r.tenant not in deferred:
                        deferred.add(r.tenant)
                        _metric("serving_quota_deferrals_total",
                                tenant=r.tenant).inc()
                    continue
                if (self.adapter_quota is not None and r.adapter
                        and lanes_per_adapter.get(r.adapter, 0)
                        >= self.adapter_quota):
                    if r.adapter not in deferred_ad:
                        deferred_ad.add(r.adapter)
                        _metric("serving_adapter_quota_deferrals_total",
                                adapter=r.adapter).inc()
                    continue
                heads[r.tenant] = i
            if not heads:
                continue
            ring = self._rings.setdefault(cls, [])
            for t in heads:
                if t not in ring:
                    ring.append(t)
            # a tenant with nothing queued in this class forfeits its
            # residual credit (classic DRR: deficit resets on empty)
            for key in [k for k in self._deficit
                        if k[0] == cls and k[1] not in heads]:
                del self._deficit[key]
            n = len(ring)
            max_cost = max(self._cost(queue[i]) for i in heads.values())
            budget = n * (int(max_cost // self.quantum) + 2)
            cur = self._cursors.get(cls, 0)
            for _ in range(budget):
                t = ring[cur % n]
                cur += 1
                if t not in heads:
                    continue
                cost = self._cost(queue[heads[t]])
                credit = self._deficit.get((cls, t), 0.0) + self.quantum
                if credit >= cost:
                    self._deficit[(cls, t)] = credit - cost
                    self._cursors[cls] = cur
                    return heads[t]
                self._deficit[(cls, t)] = credit
            self._cursors[cls] = cur
            # bounded-walk fallback: guaranteed progress for the class
            return min(heads.values())
        return None

    # --- failure contract ------------------------------------------------
    def _degrade_fifo(self, engine, why="fault"):
        """serve.sched_decide degradation: this scheduler becomes a
        counted no-op for the engine's lifetime. Brownout knobs are
        restored to base, best_effort shedding stops, and parked lanes
        resume (should_resume is unconditionally True once degraded) —
        the engine falls back to exactly its pre-scheduler FIFO
        behavior, it never deadlocks on a broken policy."""
        if self.fifo:
            return
        self.fifo = True
        if self.level != 0:
            self._transition(0, "down")
        self._apply(engine)
        self.shed_best_effort = False
        _metric("serving_runtime_degradations_total",
                what="sched_fifo").inc()
        if self._rec.enabled:
            self._rec.record("degrade", what="sched_fifo", why=why)

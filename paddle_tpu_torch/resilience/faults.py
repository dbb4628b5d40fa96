"""Deterministic fault-injection harness.

A registry of NAMED fault sites threaded through the runtime's failure-
prone seams (checkpoint IO, store ops, elastic heartbeat, serving
admission/decode, train step). Production code calls
``fault_point("site")`` — a single global-load + None check when the
harness is disarmed, so hot paths pay nothing — and the harness raises
the configured exception class on the configured hit.

Armed two ways:

* ``FLAGS_fault_injection`` (env ``FLAGS_fault_injection=...`` or
  ``paddle.set_flags``) with a spec string, e.g.::

      ckpt.metadata_replace:1:RuntimeError
      store.get:2:TimeoutError;store.set:1:ConnectionError
      store.get:rand(0.2)@42:TimeoutError      # seeded schedule

  Entries are ``site:nth:Exc`` (fire exactly on the nth hit of that
  site) or ``site:rand(p)@seed:Exc`` (each hit fires with probability p
  from a deterministic per-(seed, site) stream — the same seed always
  yields the same schedule).

* programmatically: ``arm([FaultSpec(...)])`` / ``arm_spec(text)`` /
  ``disarm()``, or the ``injected_faults(...)`` context manager tests
  use.

Every injection increments ``fault_injected_total{site=...}`` in the
observability catalog, so a chaos drill can assert that zero injected
faults escaped unhandled while every one was counted.

Port: a copy of `paddle_tpu/resilience/faults.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import random
import re
import threading

__all__ = ["FAULT_SITES", "FaultSpec", "FaultInjected", "fault_point",
           "check", "arm", "arm_spec", "disarm", "injected_faults",
           "hit_counts", "injected_counts", "parse_spec"]

# The closed set of fault sites. Instrumentation may only reference
# these names (same discipline as the observability metric catalog) —
# arming an unknown site is a spec error, not a silent no-op.
FAULT_SITES = {
    "ckpt.chunk_write": "distributed checkpoint: one chunk .npy write "
                        "(inside the atomic tmp-write + rename)",
    "ckpt.metadata_replace": "distributed checkpoint: between the chunk "
                             "writes and the metadata.json os.replace "
                             "(the kill-mid-save window)",
    "store.get": "TCPStore.get (native or in-process fallback)",
    "store.set": "TCPStore.set (native or in-process fallback)",
    "elastic.heartbeat": "ElasticManager lease beat write",
    "serve.admit": "serving admission: lane + pool reservation for a "
                   "queued request",
    "serve.decode_oom": "serving decode step: device OOM "
                        "(shed-and-requeue path)",
    "serve.prefill_chunk": "serving chunked prefill: one prompt-chunk "
                           "forward (failure aborts the task; request "
                           "requeued at the front for a fresh prefill)",
    "serve.hostsync_read": "serving decode: token-tile device->host "
                           "readback (transient failure keeps the tile "
                           "in flight and retries next step)",
    "serve.draft_verify": "serving speculative decode: draft/verify "
                          "dispatch (failure permanently degrades the "
                          "engine to non-speculative decode; streams "
                          "continue byte-identically)",
    "serve.kv_dequant": "serving quantized KV pool: dequant-fused "
                        "attention read (failure dequantizes the whole "
                        "pool to the native dtype once and drops the "
                        "quantized block format for the engine's "
                        "lifetime)",
    "serve.loadgen_tick": "traffic harness: one open-loop clock tick "
                          "(injected failure models clock skew / a "
                          "stalled driver; the tick is skipped and "
                          "counted, its arrivals re-issued next tick)",
    "serve.sched_decide": "SLO scheduler: the per-step closed-loop "
                          "decision (brownout ladder + preemption "
                          "choice); ANY failure degrades scheduling to "
                          "plain FIFO for the engine's lifetime — "
                          "knobs restored, parked lanes resumed, no "
                          "deadlock, no dropped request",
    "serve.preempt": "SLO scheduler: one decode-lane preemption "
                     "(paged-KV stays resident); failure aborts that "
                     "attempt, counted, and the victim lane keeps "
                     "decoding",
    "serve.adapter_load": "adapter store: hot-load/refcount of a named "
                          "LoRA adapter at admission; ANY failure is a "
                          "typed rejection (finish_reason=rejected, "
                          "serving_rejected_total{reason=adapter}) — "
                          "never a silent base-weights fallback; lanes "
                          "on other adapters are untouched",
    "serve.adapter_gather": "adapter store: lane-bind residency check "
                            "of the slot the fused scan will gather "
                            "A/B factors from; failure rejects the "
                            "request typed + counted instead of "
                            "gathering stale weights",
    "train.step_nonfinite": "train supervisor: force a non-finite loss "
                            "for this step (consulted via check())",
    "compile.cache_read": "PIR compile cache: artifact read (verified "
                          "load of a serialized StableHLO program; "
                          "failure degrades to recompile)",
    "compile.cache_write": "PIR compile cache: artifact write (atomic "
                           "tmp+rename; failure degrades to an uncached "
                           "but working compile)",
    "compile.verify": "PIR structural verifier entry (pir/verifier.py): "
                      "an injected fault is wrapped as the "
                      "verifier-error rule and the compile degrades to "
                      "plain jax.jit, counted "
                      "pir_fallback_total{stage=verify}",
    "compile.fuse": "PIR auto-fusion pass (pir/fuse.py): hit 1 is the "
                    "planning walk (failure degrades that compile to "
                    "plain jax.jit with identical numerics, counted "
                    "pir_fallback_total{stage=fuse}); hits 2+ are "
                    "per-group commits (failure skips THAT group — its "
                    "ops replay unfused, every other group stays "
                    "committed, no fallback)",
    "compile.shard_prop": "PIR sharding-propagation pass entry "
                          "(pir/shard_prop.py): an injected fault "
                          "aborts the pass pipeline and the compile "
                          "degrades to plain UNSHARDED jax.jit with "
                          "identical numerics, counted "
                          "pir_fallback_total{stage=passes}",
    "mesh.route": "mesh router: one replica pick for a queued request "
                  "(failure counts a failover and the request is "
                  "re-routed to the next-best replica; CircuitBreaker "
                  "per replica keeps a flapping target out of the "
                  "rotation)",
    "mesh.kv_handoff": "mesh disaggregation: serialized paged-KV block "
                       "transfer from a prefill worker to a decode "
                       "worker (retry-then-re-prefill: transient "
                       "failure retries the transfer, exhaustion "
                       "re-prefills the request on the decode side — "
                       "streams stay byte-identical either way)",
    "mesh.replica_down": "mesh membership: a replica is killed "
                         "(consulted via check(); the router tombstones "
                         "it, opens its breaker, and re-routes + "
                         "re-prefills its in-flight requests on the "
                         "survivors)",
    "mesh.transport_send": "mesh process transport: one framed "
                           "request/response round trip between router "
                           "and worker (transport.py clients; armed "
                           "BEFORE the frame leaves so a retry is "
                           "always safe — transient failure retries "
                           "under the client RetryPolicy, exhaustion "
                           "surfaces TransportError, and a failed "
                           "paged-KV import re-prefills on the decode "
                           "side, streams byte-identical)",
    "mesh.net_delay": "mesh transport network chaos: one reply held a "
                      "SHORT extra window before it lands (consulted "
                      "via check() on the receive path of both "
                      "transports); the op budget absorbs it — at most "
                      "a counted TransportTimeout and a late settle, "
                      "streams byte-identical, nobody demoted",
    "mesh.net_stall": "mesh transport network chaos: one reply held "
                      "hostage for a LONG gray-failure window (shorter "
                      "than the health detector's dead threshold by "
                      "construction); the detector trips SLOW — "
                      "demoted in ranking, counted "
                      "mesh_slow_demotions_total — BEFORE anything "
                      "trips DEAD, hedged re-prefill covers the stuck "
                      "work, and streams stay byte-identical",
    "mesh.controller_act": "mesh autoscale controller: one act() on an "
                           "AutoscaleAdvisor verdict (controller.py); "
                           "ANY failure latches the controller back to "
                           "advisory-only — counted "
                           "mesh_controller_actions_total"
                           "{action=latch_off} — while serving "
                           "continues byte-identically",
    "serve.prefix_match": "serving prefix cache: one index operation "
                          "(admission-time prompt-prefix lookup, or the "
                          "post-prefill / post-import block insert); ANY "
                          "failure degrades to a plain cache miss — full "
                          "prefill or an unindexed prompt, streams "
                          "byte-identical, never a wrong hit — counted "
                          "serving_runtime_degradations_total"
                          "{what=prefix_miss}",
    "obs.sample": "observability plane: one MetricsSampler scrape tick "
                  "(timeseries.py); ANY failure flips the sampler to "
                  "degraded — plane off, counted "
                  "obs_plane_degradations_total{what} — and serving "
                  "continues byte-identically (the plane is read-only "
                  "by construction)",
}


class FaultInjected(Exception):
    """Default injected exception; also the marker base callers may use
    to distinguish harness-made failures in logs."""


# exception classes a spec may name — a closed set so a typo'd spec
# fails at parse time instead of injecting the wrong thing
_EXC_CLASSES = {
    "FaultInjected": FaultInjected,
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "MemoryError": MemoryError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


class FaultSpec:
    """One armed fault: fire `exc` at `site` either exactly on hit
    `nth` (1-based) or on each hit with probability `prob` drawn from a
    deterministic stream seeded by (seed, site)."""

    __slots__ = ("site", "nth", "prob", "seed", "exc", "_rng", "fired")

    def __init__(self, site, nth=None, prob=None, seed=0, exc=FaultInjected):
        if site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; registered sites: "
                f"{sorted(FAULT_SITES)}")
        if (nth is None) == (prob is None):
            raise ValueError("FaultSpec needs exactly one of nth / prob")
        self.site = site
        self.nth = None if nth is None else int(nth)
        self.prob = None if prob is None else float(prob)
        self.seed = int(seed)
        self.exc = exc
        self._rng = (random.Random(f"{self.seed}:{site}")
                     if self.prob is not None else None)
        self.fired = 0

    def should_fire(self, hit):
        if self.nth is not None:
            return hit == self.nth
        return self._rng.random() < self.prob

    def __repr__(self):
        when = (f"nth={self.nth}" if self.nth is not None
                else f"rand({self.prob})@{self.seed}")
        return f"FaultSpec({self.site}, {when}, {self.exc.__name__})"


class _Plan:
    __slots__ = ("specs", "hits", "injected", "lock")

    def __init__(self, specs):
        self.specs = list(specs)
        self.hits = {}          # site -> total fault_point passes
        self.injected = {}      # site -> fires
        self.lock = threading.Lock()


_active: _Plan | None = None


def _count_injected(site, hit):
    try:
        from ..observability.catalog import metric
        metric("fault_injected_total", site=site).inc()
    except Exception:  # noqa: BLE001 — injection never fails over metrics
        pass
    try:
        from ..observability.recorder import get_recorder
        rec = get_recorder()
        if rec.enabled:
            rec.record("fault", site=site, hit=hit)
    except Exception:  # noqa: BLE001 — nor over the flight recorder
        pass


def _fire(site, raise_exc):
    """Shared body of fault_point/check; returns the exception instance
    to raise (or True for check()) when a spec fires, else None/False."""
    plan = _active
    if plan is None:
        return None if raise_exc else False
    with plan.lock:
        hit = plan.hits.get(site, 0) + 1
        plan.hits[site] = hit
        spec = None
        for s in plan.specs:
            if s.site == site and s.should_fire(hit):
                spec = s
                break
        if spec is None:
            return None if raise_exc else False
        spec.fired += 1
        plan.injected[site] = plan.injected.get(site, 0) + 1
    _count_injected(site, hit)
    if not raise_exc:
        return True
    return spec.exc(f"injected fault at {site} (hit {hit})")


def fault_point(site, **ctx):
    """Instrumentation hook: raises the armed exception when a spec for
    `site` fires on this hit; otherwise returns immediately. `ctx` is
    documentation-only (what the site was doing)."""
    exc = _fire(site, raise_exc=True)
    if exc is not None:
        raise exc


def check(site):
    """Non-raising variant for sites where the fault is a *behavior*
    rather than an exception (e.g. train.step_nonfinite: the supervisor
    fabricates a NaN loss when this returns True)."""
    return _fire(site, raise_exc=False)


def arm(specs):
    """Arm the harness with FaultSpec instances (replaces any prior
    plan). Empty/None disarms."""
    global _active
    if not specs:
        _active = None
        return
    _active = _Plan(specs)


def disarm():
    arm(None)


_RAND_RE = re.compile(r"^rand\(([0-9.]+)\)(?:@(\d+))?$")


def parse_spec(text):
    """``site:nth:Exc`` / ``site:rand(p)@seed:Exc`` entries joined by
    ``;``. Returns [FaultSpec]; raises ValueError on unknown sites,
    exception names, or malformed entries."""
    specs = []
    for entry in filter(None, (e.strip() for e in text.split(";"))):
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"malformed fault spec entry {entry!r} "
                "(want site:nth:Exc or site:rand(p)@seed:Exc)")
        site, when, exc_name = (p.strip() for p in parts)
        if exc_name not in _EXC_CLASSES:
            raise ValueError(
                f"unknown exception class {exc_name!r} in fault spec; "
                f"allowed: {sorted(_EXC_CLASSES)}")
        exc = _EXC_CLASSES[exc_name]
        m = _RAND_RE.match(when)
        if m:
            specs.append(FaultSpec(site, prob=float(m.group(1)),
                                   seed=int(m.group(2) or 0), exc=exc))
        else:
            specs.append(FaultSpec(site, nth=int(when), exc=exc))
    return specs


def arm_spec(text):
    """Arm from a FLAGS_fault_injection-style string ('' disarms)."""
    text = (text or "").strip()
    arm(parse_spec(text) if text else None)


class injected_faults:
    """Context manager for tests/drills: arm on enter, restore the
    previous plan on exit.

        with injected_faults("store.get:1:TimeoutError"):
            ...
    """

    def __init__(self, spec):
        self._spec = spec
        self._prev = None

    def __enter__(self):
        global _active
        self._prev = _active
        if isinstance(self._spec, str):
            arm_spec(self._spec)
        else:
            arm(self._spec)
        return _active

    def __exit__(self, *exc_info):
        global _active
        _active = self._prev
        return False


def hit_counts():
    """{site: times fault_point/check was reached} for the active plan
    (empty when disarmed) — the chaos drill's coverage evidence."""
    plan = _active
    if plan is None:
        return {}
    with plan.lock:
        return dict(plan.hits)


def injected_counts():
    plan = _active
    if plan is None:
        return {}
    with plan.lock:
        return dict(plan.injected)


def _arm_from_flag():
    """Honor FLAGS_fault_injection at import (env) — set_flags re-arms
    via the flags side-effect hook."""
    try:
        from ..framework.flags import flag_value
        arm_spec(flag_value("fault_injection"))
    except Exception:  # noqa: BLE001 — flags not defined yet / partial init
        pass


_arm_from_flag()

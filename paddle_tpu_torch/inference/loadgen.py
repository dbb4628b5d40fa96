"""Deterministic open-loop traffic harness for the serving engine.

reference capability: the reference validates its serving stack with ad
hoc client scripts; load behaviour (tail latency under bursts, shed
onset, SLO compliance at a target rate) is folklore. Here traffic is a
SCENARIO: a named, seeded arrival process plus a distribution over
prompt/output lengths, tenants and sampling knobs. `build_schedule`
turns (scenario, seed) into an explicit arrival list — the same pair
always yields byte-identical arrivals, so a load test is replayable
evidence, not a weather report.

The runner is OPEN LOOP: arrivals are issued by the schedule clock, not
by completion of earlier requests, so overload actually overloads (a
closed loop self-throttles and hides saturation — the coordinated-
omission trap). Each clock tick passes the `serve.loadgen_tick` fault
site; an injected failure models clock skew / a stalled driver — the
tick is skipped and counted (`loadgen_ticks_skipped_total`) and its
arrivals are re-issued on the next tick, because issuance is "everything
scheduled at or before now", not "this tick's quantum".

While driving the engine the runner samples a timeline: goodput, shed
fraction, offered rate, and the capacity signal
``headroom = 1 - offered_rate x predicted_service_seconds`` from the
PIR cost model (pir/analysis.py CostModel, calibrated by the engine's
first measured dispatch). The `slo_headroom` / `serving_overload`
gauges therefore cross into alarm BEFORE goodput collapses — the
leading indicator the SLO engine's burn rate (a trailing indicator)
cannot provide. The run report carries per-scenario TTFT/TPOT quantiles
(histogram bucket deltas over the run window), finish reasons, the
phase accountant's attribution coverage, the predicted-vs-measured cost
ratios, and an `SLOEngine` verdict.

Port: a copy of `paddle_tpu/inference/loadgen.py`, which imports no JAX
either; `SCENARIOS`, `build_schedule`, `schedule_digest` and
`check_report` are unchanged, so a (scenario, seed) pair gives the
reference's digest. What the port's engine spells differently: it keeps
its per-layer parameters in `layers` (the reference's `stacked`), and it
is warm once a program has run (`compile_reports`) or a decode graph is
captured (`_graphs`), where the reference asks for its jitted programs.
The cost model behind `slo_headroom` is `pir/analysis.price`, calibrated
by the engine's first measured dispatch. The report's `mesh` is the
MeshRouter's `mesh_report()` when the engine under test is a mesh
(inference/mesh/), None for a single engine.
"""

from __future__ import annotations

import hashlib
import json
import random
import time

import numpy as np

from ..observability.catalog import metric as _metric
from ..observability.metrics import get_registry as _get_registry
from ..observability.metrics import snapshot as _snapshot
from ..observability.quantiles import quantiles_from_cumulative
from ..observability.autoscale import check_verdict as _check_autoscale
from ..observability.recorder import get_recorder as _get_recorder
from ..observability.slo import SLOEngine
from ..observability.timeseries import RECORDING_RULES, MetricsSampler
from ..profiler.phases import get_phase_accountant as _get_phases
from ..resilience.faults import fault_point
from .scheduler import PRIORITY_CLASSES
from .serving import BackpressureError

__all__ = ["Scenario", "SCENARIOS", "build_schedule", "run_scenario",
           "check_report", "REPORT_FORMAT", "KNOWN_FINISH_REASONS"]

REPORT_FORMAT = 2

# finish reasons that count as goodput (mirrors the availability SLO's
# good set in observability/slo.py DEFAULT_SLOS)
GOOD_REASONS = ("eos", "length")

# every reason a request may legally finish with (serving.py _finish);
# check_report flags anything outside this set — a request must never
# end in an unclassifiable state, scheduler or no scheduler
KNOWN_FINISH_REASONS = ("eos", "length", "timeout", "shed", "rejected")


class Scenario:
    """One named traffic shape: an arrival process (poisson rate, burst
    trains, or a linear ramp) over a distribution of prompt/output
    lengths, tenants (weighted), sampling knobs and deadlines. All
    randomness is drawn from one seeded stream in build_schedule — a
    Scenario itself is immutable configuration."""

    __slots__ = ("name", "arrival", "rate_rps", "duration_s",
                 "rate_end_rps", "burst_n", "burst_every_s",
                 "prompt_len", "output_tokens", "tenants", "priorities",
                 "do_sample", "temperature", "top_k", "top_p",
                 "deadline_s", "shared_prefix_len", "adapter_population",
                 "adapter_zipf", "description")

    def __init__(self, name, arrival="poisson", rate_rps=10.0,
                 duration_s=1.0, rate_end_rps=None, burst_n=4,
                 burst_every_s=0.25, prompt_len=(4, 16),
                 output_tokens=(4, 12), tenants=(("-", 1.0),),
                 priorities=(("interactive", 1.0),),
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 deadline_s=None, shared_prefix_len=0,
                 adapter_population=0, adapter_zipf=1.1, description=""):
        if arrival not in ("poisson", "burst", "ramp"):
            raise ValueError(f"unknown arrival process {arrival!r}")
        for p, _w in priorities:
            if p not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown priority class {p!r}; registered: "
                    f"{list(PRIORITY_CLASSES)}")
        self.name = str(name)
        self.arrival = arrival
        self.rate_rps = float(rate_rps)
        self.duration_s = float(duration_s)
        self.rate_end_rps = (None if rate_end_rps is None
                             else float(rate_end_rps))
        self.burst_n = int(burst_n)
        self.burst_every_s = float(burst_every_s)
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.output_tokens = (int(output_tokens[0]), int(output_tokens[1]))
        self.tenants = tuple((str(t), float(w)) for t, w in tenants)
        self.priorities = tuple((str(p), float(w)) for p, w in priorities)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        # round 18: tokens of tenant-common system prompt prepended to
        # every request's (per-request) tail — the prefix-cache workload
        self.shared_prefix_len = int(shared_prefix_len)
        # round 22: every arrival names one of adapter_population demo
        # LoRA adapters ("lora0".."loraN-1"), drawn Zipf(adapter_zipf)
        # so a hot head stays resident while the tail churns slots — the
        # multi-adapter hot-swap workload (0 = base-model traffic only)
        self.adapter_population = int(adapter_population)
        self.adapter_zipf = float(adapter_zipf)
        self.description = str(description)


# The scenario matrix. Sizes are tier-1-friendly (tens of requests on a
# tiny model); production sweeps scale rate_rps/duration_s via the
# run_scenario overrides without touching the distributions.
SCENARIOS = {
    "chat": Scenario(
        "chat", arrival="poisson", rate_rps=20.0, duration_s=1.5,
        prompt_len=(4, 24), output_tokens=(4, 12),
        tenants=(("acme", 3.0), ("zee", 1.0), ("-", 1.0)),
        deadline_s=10.0,
        description="interactive chat: short prompts, short replies, "
                    "Poisson arrivals, tight TTFT expectations"),
    "long_document": Scenario(
        "long_document", arrival="poisson", rate_rps=4.0, duration_s=1.5,
        prompt_len=(32, 96), output_tokens=(4, 8),
        tenants=(("lawfirm", 1.0), ("-", 1.0)), deadline_s=20.0,
        description="long-document QA: chunked-prefill-heavy prompts, "
                    "few output tokens"),
    "offline_batch": Scenario(
        "offline_batch", arrival="burst", rate_rps=16.0, duration_s=1.5,
        burst_n=8, burst_every_s=0.5, prompt_len=(8, 32),
        output_tokens=(8, 16), tenants=(("batch", 1.0),),
        priorities=(("batch", 1.0),),
        description="offline batch: burst trains (a queue worker "
                    "flushing), throughput over latency, no deadlines"),
    "structured_output": Scenario(
        "structured_output", arrival="ramp", rate_rps=2.0,
        rate_end_rps=24.0, duration_s=2.0, prompt_len=(6, 20),
        output_tokens=(4, 10), tenants=(("jsonsvc", 1.0),),
        priorities=(("interactive", 2.0), ("batch", 1.0)),
        do_sample=True, temperature=0.8, top_p=0.95, deadline_s=15.0,
        description="structured-output extraction: sampled decode, "
                    "mixed interactive/batch classes, arrival rate "
                    "ramping into saturation — the scheduler's chaos "
                    "probe"),
    "shared_prefix": Scenario(
        "shared_prefix", arrival="poisson", rate_rps=14.0, duration_s=1.5,
        prompt_len=(4, 12), output_tokens=(4, 10),
        tenants=(("acme", 2.0), ("zee", 1.0)), shared_prefix_len=32,
        deadline_s=15.0,
        description="tenant-common system prompt (32 shared tokens) + "
                    "short per-request tail: the cross-request prefix "
                    "cache workload — after one cold prefill per tenant "
                    "every admission should resolve the shared blocks "
                    "from the index and prefill only the tail"),
    "multi_adapter": Scenario(
        "multi_adapter", arrival="poisson", rate_rps=14.0, duration_s=1.5,
        prompt_len=(4, 14), output_tokens=(4, 10),
        tenants=(("acme", 2.0), ("zee", 1.0), ("-", 1.0)),
        adapter_population=6, adapter_zipf=1.1, deadline_s=15.0,
        description="per-tenant LoRA serving: every request names one "
                    "of 6 demo adapters (Zipf-skewed, population wider "
                    "than the slot pool) so hot heads stay resident "
                    "while the tail hot-loads and evicts through the "
                    "store — the recompile-free swap workload; the "
                    "report's swap_recompiles must stay 0"),
}


def _pick_weighted(rng, pairs):
    names = [t for t, _ in pairs]
    weights = [w for _, w in pairs]
    return rng.choices(names, weights=weights, k=1)[0]


def _arrival(scenario, rng, t):
    lo, hi = scenario.prompt_len
    olo, ohi = scenario.output_tokens
    a = {
        "t": round(float(t), 6),
        "prompt_len": rng.randint(lo, hi),
        "output_tokens": rng.randint(olo, ohi),
        "tenant": _pick_weighted(rng, scenario.tenants),
        "priority": _pick_weighted(rng, scenario.priorities),
        "prompt_seed": rng.randrange(1 << 30),
        "sample_seed": rng.randrange(1 << 30),
    }
    if scenario.adapter_population > 0:
        # Zipf over the population: weight 1/(rank+1)^s — adapter-less
        # scenarios draw nothing here, so their schedules (and digests)
        # are byte-identical to pre-round-22 runs
        n = scenario.adapter_population
        s = scenario.adapter_zipf
        weights = [1.0 / float(i + 1) ** s for i in range(n)]
        a["adapter"] = "lora%d" % rng.choices(range(n),
                                              weights=weights, k=1)[0]
    return a


def build_schedule(scenario, seed=0, rate_rps=None, duration_s=None):
    """(scenario, seed) -> ordered arrival list. Deterministic: one
    `random.Random(f"{name}:{seed}")` stream drives inter-arrival gaps,
    lengths, tenants and per-request seeds, so equal inputs produce an
    equal schedule (test-pinned). `rate_rps`/`duration_s` override the
    scenario's defaults (the overload-sweep knob)."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    rng = random.Random(f"{scenario.name}:{int(seed)}")
    rate = float(rate_rps if rate_rps is not None else scenario.rate_rps)
    dur = float(duration_s if duration_s is not None
                else scenario.duration_s)
    out = []
    if scenario.arrival == "poisson":
        t = 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= dur:
                break
            out.append(_arrival(scenario, rng, t))
    elif scenario.arrival == "burst":
        # burst trains: every burst_every_s a worker flushes burst_n
        # requests nearly at once (small jitter keeps ordering honest)
        t = 0.0
        while t < dur:
            for _ in range(scenario.burst_n):
                out.append(_arrival(scenario, rng,
                                    t + rng.uniform(0.0, 0.01)))
            t += scenario.burst_every_s
    else:   # ramp — Poisson thinning against the envelope rate
        r_end = (scenario.rate_end_rps if scenario.rate_end_rps is not None
                 else rate)
        r_max = max(rate, r_end)
        t = 0.0
        while True:
            t += rng.expovariate(r_max)
            if t >= dur:
                break
            r_t = rate + (r_end - rate) * (t / dur)
            if rng.random() < r_t / r_max:
                out.append(_arrival(scenario, rng, t))
    out.sort(key=lambda a: a["t"])
    return out


def schedule_digest(schedule):
    """Stable content hash of a schedule — the replay check two runs
    compare before trusting a latency diff."""
    blob = json.dumps(schedule, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _prompt_tokens(prompt_seed, length, vocab):
    """Deterministic pseudo-prompt: a Weyl sequence over the vocab
    (never token 0, so padding stays distinguishable)."""
    lo, span = 1, max(1, int(vocab) - 1)
    idx = np.arange(int(length), dtype=np.int64)
    return ((int(prompt_seed) + idx * 2654435761) % span + lo).astype(
        np.int32)


def _tenant_prefix(scenario_name, tenant, length, vocab):
    """Round 18: the tenant-common system prompt — a Weyl sequence whose
    seed is a stable content hash of (scenario, tenant), so every
    request of one tenant shares byte-identical leading tokens (what
    the engine's prefix index actually keys on) while tenants never
    collide with each other."""
    h = hashlib.sha256(f"{scenario_name}:{tenant}".encode()).digest()
    return _prompt_tokens(int.from_bytes(h[:4], "big"), length, vocab)


# -- snapshot helpers (the slo.py windowing idea, localized) ---------------

def _hist_cum(snapshot_doc, name):
    """Histogram family -> merged {le: cumulative count} across label
    children (per-tenant siblings roll up into the scenario view)."""
    merged = {}
    for m in snapshot_doc.get("metrics", []):
        if m.get("name") != name:
            continue
        for s in m.get("samples", []):
            for le, cum in s.get("buckets", []):
                key = ("+Inf" if (isinstance(le, str) or le == float("inf"))
                       else float(le))
                merged[key] = merged.get(key, 0) + int(cum)
    return merged


def _hist_delta(new, old):
    finite = sorted(k for k in new if k != "+Inf")
    buckets = [(le, max(0, new.get(le, 0) - old.get(le, 0)))
               for le in finite]
    buckets.append(("+Inf", max(0, new.get("+Inf", 0)
                                - old.get("+Inf", 0))))
    return buckets


def _quantile_block(snap0, snap1, name):
    buckets = _hist_delta(_hist_cum(snap1, name), _hist_cum(snap0, name))
    count = buckets[-1][1] if buckets else 0
    qs = quantiles_from_cumulative(buckets)
    return {"count": int(count),
            "p50": qs.get(0.5), "p95": qs.get(0.95), "p99": qs.get(0.99)}


def _gauge_samples(snapshot_doc, name):
    out = {}
    for m in snapshot_doc.get("metrics", []):
        if m.get("name") != name:
            continue
        for s in m.get("samples", []):
            labels = s.get("labels") or {}
            key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            out[key or "-"] = float(s.get("value", 0.0))
    return out


def _counter_total(snapshot_doc, name):
    """Sum of a counter family across label children (0.0 when the
    metric never fired or the registry is disabled)."""
    total = 0.0
    for m in snapshot_doc.get("metrics", []):
        if m.get("name") != name:
            continue
        for s in m.get("samples", []):
            total += float(s.get("value", 0.0))
    return total


def _hist_cum_by(snapshot_doc, name, label):
    """Like _hist_cum, but keyed by one label's value instead of merged
    across children — the per-adapter latency view."""
    out = {}
    for m in snapshot_doc.get("metrics", []):
        if m.get("name") != name:
            continue
        for s in m.get("samples", []):
            lv = (s.get("labels") or {}).get(label)
            if lv is None:
                continue
            merged = out.setdefault(str(lv), {})
            for le, cum in s.get("buckets", []):
                key = ("+Inf" if (isinstance(le, str) or le == float("inf"))
                       else float(le))
                merged[key] = merged.get(key, 0) + int(cum)
    return out


# -- multi-adapter plumbing (round 22) -------------------------------------

def _engines_of(engine):
    """The concrete serving engines behind the harness handle: a plain
    engine is itself; a MeshRouter contributes every in-process replica
    engine (RPC proxies have no stacked params and are skipped — a
    process-worker mesh must arrive with stores pre-installed)."""
    if hasattr(engine, "mesh_report"):
        return [rep.engine for rep in engine.pool
                if hasattr(rep.engine, "layers")]
    return [engine]


def _ensure_adapter_stores(engine, names):
    """Install the deterministic demo store on every store-less engine
    the scenario will touch. Only legal on a COLD engine: programs
    already compiled without the lora argument tail must never be fed
    an adapter-carrying dispatch."""
    from .adapters import demo_store_for_engine
    n_slots = max(2, len(names))    # one fewer usable slot than names,
    for eng in _engines_of(engine):  # so the Zipf tail actually evicts
        store = getattr(eng, "adapters", None)
        if store is not None:
            missing = [n for n in names if not store.can_serve(n)]
            if missing:
                raise ValueError(
                    f"engine's adapter store cannot serve {missing}; "
                    f"registered: {store.names()}")
            continue
        if eng._graphs or eng.compile_reports:
            raise ValueError(
                "scenario names adapters but the engine is already warm "
                "and has no adapter store; build it with adapters=... "
                "(compiled programs lack the lora argument tail)")
        eng.adapters = demo_store_for_engine(eng, names, n_slots=n_slots)


def _warm_adapter_programs(engine, scenario, vocab):
    """Compile every program the run will need BEFORE the measurement
    window opens: one prefill per bucket width the scenario's prompts
    can reach, plus the decode program, each through an adapter-carrying
    request. The report's `swap_recompiles` is the jit_retrace_total
    delta over the run window — after this warmup any nonzero delta IS
    an adapter-churn recompile, which the hot-swap contract forbids.
    (On CUDA the engine captures one decode graph per (sampled, K, draft
    depth), counted in jit_retrace_total; the warm-up requests decode in
    the scenario's sampling mode at the engine's K, and the loop below
    runs until the engine idles, so that graph is captured here.)"""
    max_prompt = scenario.prompt_len[1] + scenario.shared_prefix_len
    for eng in _engines_of(engine):
        store = getattr(eng, "adapters", None)
        warm_adapter = (store.names()[0]
                        if store is not None and store.names() else None)
        covering = [b for b in eng.buckets if b >= max_prompt]
        top = covering[0] if covering else eng.buckets[-1]
        for width in [b for b in eng.buckets if b <= top]:
            eng.add_request(
                _prompt_tokens(width, width, vocab), max_new_tokens=2,
                do_sample=scenario.do_sample,
                temperature=scenario.temperature, top_k=scenario.top_k,
                top_p=scenario.top_p, adapter=warm_adapter)
        while eng.has_work():
            eng.step()
        # warmup requests are scaffolding, not traffic: drop them so
        # finish-reason / tenant accounting sees only the schedule's
        eng.finished.clear()
        # warmup used every prefill program exactly once (cold, so
        # unmeasured) — the first MEASURED dispatch was the decode
        # tile whose readback wall still contained the compile. That
        # one-shot calibration would price decode ~100x too high and
        # pin slo_headroom (and a scheduler's brownout ladder) at the
        # floor for the whole run. Drop it; the run's first dispatch
        # re-calibrates against warm programs.
        eng._cost_scale = None


# -- the runner ------------------------------------------------------------

def run_scenario(engine, scenario, seed=0, rate_rps=None, duration_s=None,
                 max_wall_s=None, sample_every_s=0.2, slo_engine=None,
                 drain=True, sampler="auto"):
    """Drive `engine` with the scenario's schedule in real time; returns
    the run report (REPORT_FORMAT). Open loop: every tick issues all
    arrivals scheduled at or before now, then advances the engine one
    step. `drain` keeps stepping after the last arrival until the engine
    idles (False = stop at schedule end, for saturation sweeps where the
    backlog would never drain). `sampler` is the embedded TSDB hook:
    "auto" attaches a MetricsSampler ticked on the schedule clock only
    when the metrics registry is enabled (plane off = zero work), None
    disables it, or pass your own MetricsSampler."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    schedule = build_schedule(scenario, seed, rate_rps=rate_rps,
                              duration_s=duration_s)
    dur = float(duration_s if duration_s is not None
                else scenario.duration_s)
    max_wall = float(max_wall_s) if max_wall_s is not None else dur + 30.0
    vocab = int(engine.embed_w.shape[0])
    mean_out = (sum(a["output_tokens"] for a in schedule)
                / max(1, len(schedule)))

    # round 22: multi-adapter runs — install the demo store on cold
    # store-less engines, then compile every program (adapter tail
    # included) BEFORE snap0 so the run window's jit_retrace_total
    # delta isolates adapter-churn recompiles (contract: zero)
    wants_adapters = scenario.adapter_population > 0
    adapter_names = sorted({a["adapter"] for a in schedule
                            if a.get("adapter")})
    if wants_adapters:
        _ensure_adapter_stores(engine, adapter_names)
        _warm_adapter_programs(engine, scenario, vocab)

    reg = _get_registry()
    phases = _get_phases()
    slo_eng = slo_engine if slo_engine is not None \
        else SLOEngine(window_s=max_wall + 60.0)
    snap0 = _snapshot(reg)
    if sampler == "auto":
        sampler = MetricsSampler() if reg.enabled else None
    t0 = time.perf_counter()
    slo_eng.observe(snap0, t0)
    if sampler is not None:
        sampler.sample(0.0)   # prime the rate/window state at run start

    m_arrivals = _metric("loadgen_arrivals_total", scenario=scenario.name)
    m_skipped = _metric("loadgen_ticks_skipped_total")
    m_headroom = _metric("slo_headroom")
    m_overload = _metric("serving_overload")

    idx = 0
    issued = 0
    rejected = 0
    ticks = 0
    ticks_skipped = 0
    offered_t = []      # schedule-clock time of every issue ATTEMPT
    timeline = []
    next_sample = 0.0
    headroom_floor = None

    def sample(now):
        nonlocal headroom_floor
        fin = engine.finished
        done = len(fin)
        good = sum(1 for r in fin.values()
                   if r.finish_reason in GOOD_REASONS)
        sheds = rejected + sum(1 for r in fin.values()
                               if r.finish_reason == "shed")
        attempts = issued + rejected
        shed_frac = sheds / attempts if attempts else 0.0
        # trailing offered rate (the open-loop demand, rejected included)
        win = 0.5
        recent = sum(1 for ta in offered_t if ta > now - win)
        rate = recent / min(win, now) if now > 0 else 0.0
        svc = engine.predicted_service_seconds(
            output_tokens=max(1, int(round(mean_out))))
        headroom = None if svc is None else 1.0 - rate * svc
        if headroom is not None:
            m_headroom.set(headroom)
            m_overload.set(1.0 if headroom <= 0.0 else 0.0)
            headroom_floor = (headroom if headroom_floor is None
                              else min(headroom_floor, headroom))
        sched = getattr(engine, "scheduler", None)
        timeline.append({
            "t": round(now, 4), "issued": issued, "rejected": rejected,
            "finished": done, "good": good, "shed_frac": round(
                shed_frac, 4),
            "offered_rps": round(rate, 2),
            "service_s": svc, "headroom": headroom,
            "brownout": None if sched is None else int(sched.level),
            "preemptions": (None if sched is None
                            else int(sched.preempt_requests)),
        })
        if sampler is not None:
            # TSDB tick on the schedule clock (deterministic per run
            # timing; a failed tick degrades the plane, never the run)
            sampler.sample(now)

    while True:
        now = time.perf_counter() - t0
        ticks += 1
        try:
            fault_point("serve.loadgen_tick", scenario=scenario.name)
        except Exception:   # noqa: BLE001 — clock skew model: skip + count
            ticks_skipped += 1
            m_skipped.inc()
            continue        # arrivals with t <= now re-issue next tick
        while idx < len(schedule) and schedule[idx]["t"] <= now:
            a = schedule[idx]
            idx += 1
            offered_t.append(now)
            prompt = _prompt_tokens(a["prompt_seed"], a["prompt_len"],
                                    vocab)
            if scenario.shared_prefix_len > 0:
                prompt = np.concatenate([
                    _tenant_prefix(scenario.name, a["tenant"],
                                   scenario.shared_prefix_len, vocab),
                    prompt])
            try:
                engine.add_request(
                    prompt, max_new_tokens=a["output_tokens"],
                    do_sample=scenario.do_sample,
                    temperature=scenario.temperature,
                    top_k=scenario.top_k, top_p=scenario.top_p,
                    seed=a["sample_seed"],
                    deadline_s=scenario.deadline_s, tenant=a["tenant"],
                    priority=a.get("priority", "interactive"),
                    # adapter-less arrivals keep the pre-round-22 call
                    # frame (engine doubles without the kwarg still work)
                    **({"adapter": a["adapter"]}
                       if a.get("adapter") else {}))
                issued += 1
                m_arrivals.inc()
            except BackpressureError:
                rejected += 1
        if engine.has_work():
            engine.step()
        elif idx < len(schedule):
            # ahead of the schedule: yield briefly instead of spinning
            time.sleep(min(0.002,
                           max(0.0, schedule[idx]["t"] - now)))
        if now >= next_sample:
            sample(now)
            next_sample = now + float(sample_every_s)
        if idx >= len(schedule) and not (drain and engine.has_work()):
            break
        if now > max_wall:
            break

    t1 = time.perf_counter()
    sample(t1 - t0)
    snap1 = _snapshot(reg)
    slo_eng.observe(snap1, t1)
    verdict = slo_eng.evaluate(emit=True)

    finished = {}
    tenants = {}
    classes = {}
    class_ttfts: dict[str, list] = {}
    for r in engine.finished.values():
        finished[r.finish_reason] = finished.get(r.finish_reason, 0) + 1
        trow = tenants.setdefault(r.tenant, {"finished": 0, "good": 0})
        trow["finished"] += 1
        trow["good"] += int(r.finish_reason in GOOD_REASONS)
        cls = getattr(r, "priority", "interactive")
        crow = classes.setdefault(cls, {"finished": 0, "good": 0})
        crow["finished"] += 1
        crow["good"] += int(r.finish_reason in GOOD_REASONS)
        if r.t_first is not None:
            class_ttfts.setdefault(cls, []).append(
                r.t_first - r.t_arrival)
    for cls, ts in class_ttfts.items():
        ts.sort()
        classes[cls]["ttft_p50"] = round(ts[int(0.5 * (len(ts) - 1))], 6)
        classes[cls]["ttft_p95"] = round(ts[int(0.95 * (len(ts) - 1))], 6)
    total_done = sum(finished.values())
    good = sum(finished.get(rn, 0) for rn in GOOD_REASONS)

    phases_report = phases.report() if phases.enabled else None
    cost = {"programs": engine.predicted_costs(),
            "ratio": _gauge_samples(snap1, "pir_cost_ratio")}

    # speculative-decode evidence: this run's draft/accept deltas (None
    # when the engine isn't speculative). One run = one scenario, so
    # this IS the per-scenario acceptance the drafting table is tuned on
    drafted = (_counter_total(snap1, "serving_draft_tokens_total")
               - _counter_total(snap0, "serving_draft_tokens_total"))
    accepted = (_counter_total(snap1, "serving_accepted_tokens_total")
                - _counter_total(snap0, "serving_accepted_tokens_total"))
    custom = getattr(engine, "_drafter", None)
    speculative = None
    if drafted > 0:
        speculative = {
            "drafter": (getattr(custom, "label", "custom")
                        if custom is not None
                        else f"ngram:{getattr(engine, 'draft_ngram', '?')}"),
            "draft_depth": int(getattr(engine, "draft_depth", 0)),
            "draft_tokens": int(drafted),
            "accepted_tokens": int(accepted),
            "acceptance": round(accepted / drafted, 4),
        }

    # prefix-cache evidence: this run's hit/miss/saved deltas (None when
    # the engine has no prefix index). hit_rate is per-ADMISSION — a
    # deferred-then-admitted request counts once, a faulted lookup
    # counts as a miss (the degrade-to-miss contract)
    prefix = None
    if getattr(engine, "_prefix", None) is not None:
        p_hits = (_counter_total(snap1, "serving_prefix_hits_total")
                  - _counter_total(snap0, "serving_prefix_hits_total"))
        p_miss = (_counter_total(snap1, "serving_prefix_misses_total")
                  - _counter_total(snap0, "serving_prefix_misses_total"))
        p_saved = (
            _counter_total(snap1, "serving_prefix_tokens_saved_total")
            - _counter_total(snap0, "serving_prefix_tokens_saved_total"))
        lookups = p_hits + p_miss
        prefix = {
            "hits": int(p_hits),
            "misses": int(p_miss),
            "hit_rate": (round(p_hits / lookups, 4) if lookups else None),
            "tokens_saved": int(p_saved),
            "shared_blocks": int(_counter_total(
                snap1, "serving_prefix_shared_blocks")),
            "evictions": int(
                _counter_total(snap1, "serving_prefix_evictions_total")
                - _counter_total(snap0, "serving_prefix_evictions_total")),
            "cow_forks": int(
                _counter_total(snap1, "serving_prefix_cow_forks_total")
                - _counter_total(snap0, "serving_prefix_cow_forks_total")),
        }

    # multi-adapter evidence (None unless the scenario names adapters):
    # run-window hot-load/evict counts, the per-adapter latency split,
    # and swap_recompiles — the jit_retrace_total delta, which warmup
    # pins to "adapter churn only" and the hot-swap contract pins to 0
    adapters_block = None
    if wants_adapters:
        t0b = _hist_cum_by(snap0, "serving_adapter_ttft_seconds", "adapter")
        t1b = _hist_cum_by(snap1, "serving_adapter_ttft_seconds", "adapter")
        p0b = _hist_cum_by(snap0, "serving_adapter_tpot_seconds", "adapter")
        p1b = _hist_cum_by(snap1, "serving_adapter_tpot_seconds", "adapter")
        per = {}
        for nm in sorted(set(t1b) | set(p1b)):
            row = {}
            td = _hist_delta(t1b.get(nm, {}), t0b.get(nm, {}))
            if td and td[-1][1]:
                q = quantiles_from_cumulative(td)
                row.update(ttft_count=int(td[-1][1]),
                           ttft_p50=q.get(0.5), ttft_p95=q.get(0.95))
            pd = _hist_delta(p1b.get(nm, {}), p0b.get(nm, {}))
            if pd and pd[-1][1]:
                q = quantiles_from_cumulative(pd)
                row.update(tpot_count=int(pd[-1][1]),
                           tpot_p50=q.get(0.5), tpot_p95=q.get(0.95))
            if row:
                per[nm] = row
        stats = [s.stats() for s in
                 (getattr(e, "adapters", None) for e in _engines_of(engine))
                 if s is not None]
        adapters_block = {
            "population": int(scenario.adapter_population),
            "names": adapter_names,
            "loads": int(
                _counter_total(snap1, "serving_adapter_loads_total")
                - _counter_total(snap0, "serving_adapter_loads_total")),
            "evictions": int(
                _counter_total(snap1, "serving_adapter_evictions_total")
                - _counter_total(snap0,
                                 "serving_adapter_evictions_total")),
            "load_failures": int(
                _counter_total(snap1,
                               "serving_adapter_load_failures_total")
                - _counter_total(snap0,
                                 "serving_adapter_load_failures_total")),
            "resident": sum(s["resident"] for s in stats),
            "swap_recompiles": int(
                _counter_total(snap1, "jit_retrace_total")
                - _counter_total(snap0, "jit_retrace_total")),
            "per_adapter": per,
        }

    report = {
        "format": REPORT_FORMAT,
        "scenario": scenario.name,
        "seed": int(seed),
        "schedule": {"arrivals": len(schedule),
                     "digest": schedule_digest(schedule),
                     "duration_s": dur,
                     "mean_output_tokens": round(mean_out, 2)},
        "wall_s": round(t1 - t0, 4),
        "issued": issued,
        "rejected": rejected,
        "ticks": ticks,
        "ticks_skipped": ticks_skipped,
        "finished": finished,
        "goodput": round(good / total_done, 4) if total_done else None,
        "goodput_rps": round(good / (t1 - t0), 2),
        "shed": finished.get("shed", 0) + rejected,
        "timeouts": finished.get("timeout", 0),
        "ttft": _quantile_block(snap0, snap1, "serving_ttft_seconds"),
        "tpot": _quantile_block(snap0, snap1, "serving_tpot_seconds"),
        "tenants": tenants,
        "classes": classes,
        "slo": verdict,
        "phases": phases_report,
        "coverage": (phases_report or {}).get("coverage"),
        "cost": cost,
        "speculative": speculative,
        "prefix": prefix,
        "adapters": adapters_block,
        "headroom_floor": headroom_floor,
        "timeline": timeline,
        # scheduler evidence (all zero/None for a scheduler-less engine):
        # end-of-run brownout level must be 0 — check_report gates it
        "brownout_level_end": _gauge_samples(
            snap1, "serving_brownout_level").get("-", 0.0),
        "brownout_transitions": (
            _counter_total(snap1, "serving_brownout_transitions_total")
            - _counter_total(snap0, "serving_brownout_transitions_total")),
        "preemptions": (
            _counter_total(snap1, "serving_preemptions_total")
            - _counter_total(snap0, "serving_preemptions_total")),
        "quota_deferrals": (
            _counter_total(snap1, "serving_quota_deferrals_total")
            - _counter_total(snap0, "serving_quota_deferrals_total")),
        "scheduler": (None if getattr(engine, "scheduler", None) is None
                      else {"level_end": int(engine.scheduler.level),
                            "fifo": bool(engine.scheduler.fifo),
                            "preempts": int(
                                engine.scheduler.preempt_requests)}),
        # mesh evidence (None for a single engine): per-replica
        # goodput/headroom snapshots + handoff/failover accounting from
        # MeshRouter.mesh_report() — the engine surface is identical,
        # so the harness only needs this one hook
        "mesh": (engine.mesh_report()
                 if hasattr(engine, "mesh_report") else None),
        # embedded-TSDB evidence (None when the plane is off): per-rule
        # latest value + point counts, series/sample totals, degradation
        "timeseries": sampler.summary() if sampler is not None else None,
    }
    rec = _get_recorder()
    if rec.enabled:
        rec.record("profile", scenario=scenario.name, seed=int(seed),
                   issued=issued, goodput=report["goodput"],
                   coverage=report["coverage"],
                   slo_ok=verdict.get("ok"))
    return report


def check_report(report, min_coverage=0.95, min_acceptance=None,
                 require_timeseries=False, require_autoscale=False,
                 min_prefix_hit_rate=None, min_adapter_loads=None):
    """Acceptance gate over a run report -> list of problems (empty =
    pass). Checked: an SLO verdict exists, phase attribution covers at
    least `min_coverage` of engine wall time, the cost model priced at
    least one dispatched program (predicted-vs-measured gauge is
    populated), every finished request carries a known finish reason,
    and the brownout ladder returned to level 0 by end of run (a run
    that leaves the engine degraded is not a pass). `min_acceptance`
    (speculative runs only) additionally requires a speculative block
    with draft acceptance at or above the floor. `require_timeseries`
    gates the observability plane: a timeseries block must exist, not
    be degraded, and every recording rule must have >= 1 populated
    point. `require_autoscale` (mesh runs) requires an internally
    consistent autoscale verdict (autoscale.check_verdict).
    `min_prefix_hit_rate` (prefix-cache runs) requires a prefix block
    with admission hit_rate at or above the floor and tokens actually
    saved — a warm shared-prefix run that saved nothing is a broken
    index, not a pass. `min_adapter_loads` (multi-adapter runs) requires
    an adapters block whose run-window hot-loads meet the floor, whose
    per-adapter latency split is populated, and — the hot-swap contract
    — whose swap_recompiles is exactly 0: adapter churn that recompiles
    the fused programs is a regression, however good the latency."""
    problems = []
    if min_adapter_loads is not None:
        ad = report.get("adapters")
        if not ad:
            problems.append("no adapters block in report "
                            "(scenario not multi-adapter?)")
        else:
            # the brownout ladder legally constructs at most one new
            # decode program per transition (decode_steps is part of
            # the compile key); only the excess is adapter churn
            allowed = int(report.get("brownout_transitions") or 0)
            if ad.get("swap_recompiles", 0) > allowed:
                problems.append(
                    f"adapter hot-swap recompiled: jit_retrace_total "
                    f"moved by {ad['swap_recompiles']} inside the run "
                    f"window (contract: 0 beyond the {allowed} brownout "
                    f"program swaps)")
            if ad.get("loads", 0) < float(min_adapter_loads):
                problems.append(
                    f"adapter hot-loads {ad.get('loads')} < "
                    f"{min_adapter_loads}")
            if not ad.get("per_adapter"):
                problems.append("per-adapter latency split is empty "
                                "(adapter histograms never observed)")
    if min_prefix_hit_rate is not None:
        pfx = report.get("prefix")
        if not pfx:
            problems.append("no prefix block in report "
                            "(engine prefix cache off?)")
        else:
            if (pfx.get("hit_rate") or 0.0) < float(min_prefix_hit_rate):
                problems.append(
                    f"prefix hit_rate {pfx.get('hit_rate')} < "
                    f"{min_prefix_hit_rate}")
            if pfx.get("tokens_saved", 0) <= 0:
                problems.append("prefix cache saved no prefill tokens")
    if require_timeseries:
        ts = report.get("timeseries")
        if not isinstance(ts, dict):
            problems.append("no timeseries block in report (plane off?)")
        else:
            if ts.get("degraded"):
                problems.append("observability plane degraded during run")
            rules = ts.get("rules") or {}
            empty = sorted(n for n in RECORDING_RULES
                           if not (rules.get(n) or {}).get("points"))
            if empty:
                problems.append(
                    f"recording rules with no populated series: {empty}")
    if require_autoscale:
        verdict = (report.get("mesh") or {}).get("autoscale")
        if verdict is None:
            problems.append("no autoscale verdict in mesh report")
        else:
            problems.extend(f"autoscale: {p}"
                            for p in _check_autoscale(verdict))
    if min_acceptance is not None:
        spec = report.get("speculative")
        if not spec:
            problems.append("no speculative block in report "
                            "(engine not speculative / no drafts issued)")
        elif spec.get("acceptance", 0.0) < float(min_acceptance):
            problems.append(
                f"draft acceptance {spec.get('acceptance')} < "
                f"{min_acceptance} (drafter {spec.get('drafter')})")
    slo_v = report.get("slo")
    if not isinstance(slo_v, dict) or "ok" not in slo_v:
        problems.append("no SLO verdict in report")
    cov = report.get("coverage")
    if cov is None:
        problems.append("no phase-attribution coverage "
                        "(profiler disabled?)")
    elif cov < float(min_coverage):
        problems.append(f"phase attribution coverage {cov:.3f} "
                        f"< {min_coverage}")
    if not report.get("cost", {}).get("ratio"):
        problems.append("pir_cost_ratio gauge not populated "
                        "(no measured dispatch priced)")
    if not report.get("issued"):
        problems.append("no requests issued")
    unknown = sorted(set(report.get("finished") or {})
                     - set(KNOWN_FINISH_REASONS))
    if unknown:
        problems.append(
            f"requests finished with unknown reason(s): {unknown}")
    sched = report.get("scheduler")
    level_end = (sched or {}).get("level_end",
                                  report.get("brownout_level_end"))
    if level_end:
        problems.append(
            f"serving_brownout_level did not return to 0 by end of run "
            f"(level {level_end})")
    return problems

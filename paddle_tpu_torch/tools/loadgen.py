#!/usr/bin/env python
"""Traffic harness CLI: drive the serving engine with a seeded scenario
and print the machine-readable run report.

reference: tools/loadgen.py. The engine under test is a tiny llama (the
reference CLI's shape: vocab 128, hidden 64, 2 layers, 4 heads; random
weights from seed(0)) on CUDA, or on the CPU with `--device cpu`. The
harness measures the serving runtime (scheduler, chunked prefill, fused
decode, readback), not model quality; point a scenario at a real
deployment by importing paddle_tpu_torch.inference.loadgen and passing
your own engine.

Usage:
  python3 -m paddle_tpu_torch.tools.loadgen --scenario chat --seed 0
          # report JSON
  python3 -m paddle_tpu_torch.tools.loadgen --device cpu --check
          # acceptance gate: exit 0 iff an SLO verdict exists, phase
          # attribution covers >=95% of engine wall time, the
          # predicted-vs-measured cost gauge is populated, every finish
          # reason is known, the recording rules are populated and the
          # brownout ladder ended back at level 0
  python3 -m paddle_tpu_torch.tools.loadgen --scenario structured_output \\
          --scheduler --check     # with the SLO scheduler's closed loop
  python3 -m paddle_tpu_torch.tools.loadgen --list     # scenarios
  python3 -m paddle_tpu_torch.tools.loadgen --rate 400 --no-drain
          # overload
  python3 -m paddle_tpu_torch.tools.loadgen --scenario chat --dashboard
          # the run's TSDB as a terminal dashboard on stderr
  python3 -m paddle_tpu_torch.tools.loadgen --device cpu --replicas 2 \\
          --disaggregate --check --out report.json
          # the serving mesh: prefill and decode replicas in process
  python3 -m paddle_tpu_torch.tools.autoscale_report report.json --check
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import loadgen
from paddle_tpu_torch.profiler.phases import get_phase_accountant


def _counter_sum(name):
    fam = obs.get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(c.value for c in fam.children().values())


def build_engine(device="cuda", max_batch=4, num_blocks=128, block_size=8,
                 prefill_buckets=(16, 32), max_queue=64, **kw):
    """The harness's default engine under test: tiny llama, small paged
    pool, bounded admission queue (so overload sweeps exercise
    backpressure instead of unbounded memory)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=256)
    pt.seed(0)
    model = LlamaForCausalLM(cfg, device=device)
    return ContinuousBatchingEngine(
        model, num_blocks=num_blocks, block_size=block_size,
        max_batch=max_batch, prefill_buckets=prefill_buckets,
        max_queue=max_queue, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="chat",
                    choices=sorted(loadgen.SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--rate", type=float, default=None,
                    help="override the scenario's arrival rate (rps)")
    ap.add_argument("--duration", type=float, default=None,
                    help="override the scenario's duration (s)")
    ap.add_argument("--max-wall", type=float, default=None,
                    help="hard wall-clock cap on the run (s)")
    ap.add_argument("--no-drain", action="store_true",
                    help="stop at schedule end instead of draining the "
                         "backlog (saturation sweeps)")
    ap.add_argument("--scheduler", action="store_true",
                    help="run the engine under the closed-loop SLO "
                         "scheduler (priority preemption + tenant DRR + "
                         "brownout ladder)")
    ap.add_argument("--check", action="store_true",
                    help="acceptance gate: exit nonzero unless the report "
                         "has an SLO verdict, >=95%% phase attribution, a "
                         "populated cost gauge, only known finish reasons, "
                         "populated recording rules and the brownout "
                         "ladder back at 0")
    ap.add_argument("--speculative", action="store_true",
                    help="run the engine with speculative fused decode, "
                         "feeding the scenario's tuned n-gram statistics "
                         "(inference/drafting.py) into the drafter= hook; "
                         "the report gains a per-scenario acceptance block")
    ap.add_argument("--flat-drafter", action="store_true",
                    help="with --speculative: use the engine's built-in "
                         "flat n-gram drafter instead of the per-scenario "
                         "statistics (the A/B baseline)")
    ap.add_argument("--min-acceptance", type=float, default=None,
                    help="with --check on a speculative run: fail unless "
                         "draft acceptance reaches this floor")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the engine's cross-request prefix cache; "
                         "implied by the shared_prefix scenario — the "
                         "report gains a prefix block with "
                         "hit_rate/tokens_saved")
    ap.add_argument("--min-prefix-hit-rate", type=float, default=None,
                    help="with --check on a prefix-cache run: fail unless "
                         "the admission hit rate reaches this floor "
                         "(default 0.5 for the shared_prefix scenario)")
    ap.add_argument("--min-adapter-loads", type=float, default=None,
                    help="with --check on a multi-adapter run: fail "
                         "unless the run window hot-loaded at least this "
                         "many adapters, the per-adapter latency split "
                         "is populated, and swap_recompiles is exactly 0 "
                         "(default 1 for the multi_adapter scenario)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N in-process engine replicas behind the "
                         "mesh router instead of one engine; the report "
                         "gains a mesh block with per-replica goodput "
                         "and headroom columns")
    ap.add_argument("--disaggregate", action="store_true",
                    help="with --replicas >= 2: split the pool into "
                         "prefill and decode workers with serialized "
                         "paged-KV handoff between them")
    ap.add_argument("--processes", type=int, default=0, metavar="N",
                    help="run N replicas behind the process-native "
                         "frame transport (ProcessReplicaPool, loopback "
                         "clients) instead of bare in-process engines; "
                         "overrides --replicas; composes with "
                         "--disaggregate")
    ap.add_argument("--slow-replica", action="store_true",
                    help="degrade one worker of a process mesh with a "
                         "duty-cycled step wedge (parked replies, no "
                         "progress while busy) so the gray-failure path "
                         "carries the run: the health detector demotes "
                         "it SLOW, routing avoids it, and with --check "
                         "the run must still meet its TTFT SLO with the "
                         "degraded worker alive; implies --processes 2 "
                         "when no process mesh was requested")
    ap.add_argument("--slow-ttft-burn", type=float, default=3.0,
                    help="with --check --slow-replica: max allowed "
                         "ttft_p95 burn rate (observed/objective) for "
                         "the degraded run; a mesh that keeps placing on "
                         "the wedged worker burns far past 3")
    ap.add_argument("--min-coverage", type=float, default=0.95)
    ap.add_argument("--dashboard", action="store_true",
                    help="render the run's embedded TSDB as a terminal "
                         "dashboard (tools/dashboard.py) on stderr at "
                         "end of run")
    ap.add_argument("--out", default=None, help="write the report JSON here "
                    "(default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(loadgen.SCENARIOS):
            sc = loadgen.SCENARIOS[name]
            print(f"{name:18s} {sc.arrival:8s} {sc.rate_rps:6.1f} rps "
                  f"x {sc.duration_s:4.1f}s  {sc.description}")
        return 0
    obs.enable()
    get_phase_accountant().enabled = True
    kw = {}
    prefix_on = args.prefix_cache or args.scenario == "shared_prefix"
    if prefix_on:
        kw["prefix_cache"] = True
    if args.speculative:
        from paddle_tpu_torch.inference import drafting
        kw["speculative_decode"] = True
        kw["draft_depth"] = drafting.scenario_draft_depth(args.scenario)
        if not args.flat_drafter:
            kw["drafter"] = drafting.scenario_drafter(args.scenario)
    if args.slow_replica and args.processes < 2:
        # the wedge needs the process transport: only ProcessReplica
        # freezes its progress counters when a step reply is parked
        args.processes = 2
    victim = None
    if args.processes > 1 or args.replicas > 1:
        from paddle_tpu_torch.inference import SLOScheduler
        from paddle_tpu_torch.inference.mesh import (MeshRouter,
                                                     ProcessReplicaPool,
                                                     ReplicaPool)
        if args.processes > 1:
            pool = ProcessReplicaPool(
                lambda: build_engine(args.device, **kw), n=args.processes,
                transport="loopback",
                disaggregate=args.disaggregate, store_port=0)
        else:
            pool = ReplicaPool(
                lambda: build_engine(args.device, **kw), n=args.replicas,
                disaggregate=args.disaggregate, store_port=0)
        if args.slow_replica:
            # wedge the last worker: every 8th real step starts a 0.6 s
            # episode during which its step reply stays parked (0.0
            # wall, progress counters frozen) — alive-but-wrong, the
            # shape the health detector scores; between episodes it
            # works normally, so the run always drains
            victim = pool.alive()[-1]
            _inner = victim.engine.step
            _wedge = {"until": 0.0, "reals": 0}

            def _wedged_step(_inner=_inner, _wedge=_wedge):
                now = time.perf_counter()
                if now < _wedge["until"]:
                    return 0.0
                _wedge["reals"] += 1
                if _wedge["reals"] % 8 == 0:
                    _wedge["until"] = now + 0.6
                    return 0.0
                return _inner()

            victim.engine.step = _wedged_step
        engine = MeshRouter(
            pool, scheduler=SLOScheduler() if args.scheduler else None)
    else:
        engine = build_engine(args.device,
                              scheduler=True if args.scheduler else None,
                              **kw)
    from paddle_tpu_torch.observability.timeseries import MetricsSampler
    sampler = MetricsSampler()
    report = loadgen.run_scenario(
        engine, args.scenario, seed=args.seed, rate_rps=args.rate,
        duration_s=args.duration, max_wall_s=args.max_wall,
        drain=not args.no_drain, sampler=sampler)

    text = json.dumps(report, indent=1, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)

    slo_state = "PASS" if report["slo"].get("ok") else "BREACH"
    cov = report.get("coverage")
    spec = report.get("speculative")
    spec_str = "" if not spec else (
        f" drafter={spec['drafter']} acceptance={spec['acceptance']}"
        f" ({spec['accepted_tokens']}/{spec['draft_tokens']})")
    print(f"\n# scenario={report['scenario']} seed={report['seed']} "
          f"device={args.device} issued={report['issued']} "
          f"goodput={report['goodput']} ttft_p95={report['ttft']['p95']} "
          f"slo={slo_state} "
          f"coverage={cov if cov is None else round(cov, 4)}{spec_str}",
          file=sys.stderr)
    pfx = report.get("prefix")
    if pfx:
        print(f"# prefix: hit_rate={pfx['hit_rate']} "
              f"({pfx['hits']}/{pfx['hits'] + pfx['misses']}) "
              f"tokens_saved={pfx['tokens_saved']} "
              f"shared_blocks={pfx['shared_blocks']} "
              f"evictions={pfx['evictions']} cow_forks={pfx['cow_forks']}",
              file=sys.stderr)
    adp = report.get("adapters")
    if adp:
        print(f"# adapters: population={adp['population']} "
              f"loads={adp['loads']} evictions={adp['evictions']} "
              f"load_failures={adp['load_failures']} "
              f"resident={adp['resident']} "
              f"swap_recompiles={adp['swap_recompiles']}",
              file=sys.stderr)

    mesh = report.get("mesh")
    if mesh:
        print(f"# mesh: replicas={len(mesh['replicas'])} "
              f"disaggregate={mesh['disaggregate']} "
              f"handoffs={mesh['handoffs']} "
              f"failovers={mesh['failovers'] or '{}'} "
              f"sim_tok_per_s={mesh['sim_tok_per_s']} "
              f"(simulated-parallel wall)", file=sys.stderr)
        if mesh.get("slow") or args.slow_replica:
            print(f"# mesh health: slow={mesh.get('slow')} "
                  f"suspicion={mesh.get('suspicion')} "
                  f"slow_demotions="
                  f"{_counter_sum('mesh_slow_demotions_total')} "
                  f"hedges={_counter_sum('mesh_hedges_total')}",
                  file=sys.stderr)
        print(f"# {'replica':10s} {'role':8s} {'alive':5s} {'routed':>6s} "
              f"{'finished':>8s} {'tok/s':>8s} {'headroom':>9s}",
              file=sys.stderr)
        rate = report["issued"] / max(report["wall_s"], 1e-9)
        for name, row in sorted(mesh["replicas"].items()):
            svc = row["predicted_service_s"]
            n_alive = max(1, sum(r["alive"]
                                 for r in mesh["replicas"].values()))
            head = (None if svc is None
                    else round(1.0 - (rate / n_alive) * svc, 3))
            print(f"# {name:10s} {row['role']:8s} "
                  f"{str(row['alive']):5s} {row['routed']:6d} "
                  f"{row['finished']:8d} "
                  f"{str(row['tok_per_s']):>8s} {str(head):>9s}",
                  file=sys.stderr)

    if args.dashboard:
        from paddle_tpu_torch.tools import dashboard
        doc = (engine.collector.merged_doc()
               if getattr(engine, "collector", None) is not None
               else sampler.snapshot_doc())
        print(dashboard.render(doc, report=report), file=sys.stderr)

    if args.check:
        problems = loadgen.check_report(
            report, min_coverage=args.min_coverage,
            min_acceptance=((args.min_acceptance
                             if args.min_acceptance is not None else 0.0)
                            if args.speculative else None),
            require_timeseries=True,
            require_autoscale=args.replicas > 1,
            min_prefix_hit_rate=(
                args.min_prefix_hit_rate
                if args.min_prefix_hit_rate is not None
                else (0.5 if prefix_on
                      and loadgen.SCENARIOS[args.scenario].shared_prefix_len
                      else None)),
            min_adapter_loads=(
                args.min_adapter_loads
                if args.min_adapter_loads is not None
                else (1 if loadgen.SCENARIOS[
                    args.scenario].adapter_population else None)))
        if args.slow_replica:
            # the gray-failure acceptance: the wedged worker must have
            # been demoted SLOW (never killed — that would be the crash
            # path, not gray immunity), every request must finish, and
            # TTFT p95 must hold within the burn bound — a mesh that
            # fails to route around the wedge blows far past it
            if _counter_sum("mesh_slow_demotions_total") < 1:
                problems.append("slow-replica run never demoted the "
                                "wedged worker SLOW")
            if victim is not None and not victim.alive:
                problems.append("slow-replica run killed the wedged "
                                "worker (gray must not escalate to "
                                "dead)")
            for s in report["slo"].get("slos", ()):
                if s["name"] == "ttft_p95" \
                        and s.get("burn_rate", 0.0) > args.slow_ttft_burn:
                    problems.append(
                        "TTFT p95 degraded past the slow-replica bound "
                        f"(burn {s['burn_rate']:.2f} > "
                        f"{args.slow_ttft_burn}): the mesh did not "
                        "route around the wedge")
                if s["name"] == "availability" and not s.get("ok"):
                    problems.append("requests lost with one degraded "
                                    "worker (availability SLO breached)")
        for p in problems:
            print(f"CHECK FAIL: {p}", file=sys.stderr)
        if problems:
            return 1
        extra = "" if not spec else (
            f", per-scenario acceptance {spec['acceptance']}")
        if pfx:
            extra += (f", prefix hit_rate {pfx['hit_rate']} "
                      f"({pfx['tokens_saved']} prefill tokens saved)")
        if adp:
            extra += (f", {adp['loads']} adapter hot-loads / "
                      f"{adp['evictions']} evictions, "
                      f"{adp['swap_recompiles']} swap recompiles")
        if args.replicas > 1:
            auto = (report.get("mesh") or {}).get("autoscale") or {}
            extra += (f", autoscale {auto.get('action')} -> "
                      f"desired={auto.get('desired_replicas')}")
        print("CHECK PASS: SLO verdict present, attribution "
              f">={args.min_coverage:.0%}, cost gauge populated, "
              f"recording rules populated{extra}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

The serving mesh (`--replicas`, `--processes`, `--disaggregate`,
`--slow-replica`) raises NotImplementedError until it is ported
(ROADMAP.md, slice 4, step 6).
"""

from __future__ import annotations

import argparse
import json
import sys

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import loadgen
from paddle_tpu_torch.profiler.phases import get_phase_accountant


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
                    help="engine replicas behind the mesh router (not "
                         "ported: more than 1 raises)")
    ap.add_argument("--processes", type=int, default=0, metavar="N",
                    help="replicas behind the process transport (not "
                         "ported: more than 1 raises)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="split prefill and decode workers (not ported: "
                         "raises)")
    ap.add_argument("--slow-replica", action="store_true",
                    help="gray-failure drill of a process mesh (not "
                         "ported: raises)")
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
    if (args.replicas > 1 or args.processes > 1 or args.disaggregate
            or args.slow_replica):
        raise NotImplementedError(
            "the serving mesh (--replicas, --processes, --disaggregate, "
            "--slow-replica) is not ported yet (ROADMAP.md Queue 1, slice "
            "4, step 6)")

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
    engine = build_engine(args.device,
                          scheduler=True if args.scheduler else None, **kw)
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
          f"device={engine.device} issued={report['issued']} "
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

    if args.dashboard:
        from paddle_tpu_torch.tools import dashboard
        print(dashboard.render(sampler.snapshot_doc(), report=report),
              file=sys.stderr)

    if args.check:
        problems = loadgen.check_report(
            report, min_coverage=args.min_coverage,
            min_acceptance=((args.min_acceptance
                             if args.min_acceptance is not None else 0.0)
                            if args.speculative else None),
            require_timeseries=True,
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
        print("CHECK PASS: SLO verdict present, attribution "
              f">={args.min_coverage:.0%}, cost gauge populated, "
              f"recording rules populated{extra}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

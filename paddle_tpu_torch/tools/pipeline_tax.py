#!/usr/bin/env python
"""The pipeline tax: LlamaPipeRunner's schedules against SpmdTrainer at the
same process count.

reference: tools/pipeline_tax.py, which compares its scan-over-ticks
pipeline with pure GSPMD by XLA's cost-model flops, wall clock on a
virtual CPU mesh and the analytic masked-tick ratio (mb + pp - 1) / mb.

Here, for each (pp, microbatches) row and schedule, at the reference's
tiny config (CFG, BATCH x SEQ tokens):

- the flops of one training step's gradient computation, from the
  PIR CostModel of the captured step (pir.capture on fake tensors, then
  `CostModel.analyze`): the model's forward and backward for the SPMD row,
  the schedule's loss and gradient function for a pipeline row. The
  captures run on the CPU, in worker processes side by side
  (`FlopsCaptures`; a capture of a pipeline step takes tens of seconds of
  host time and no device time); at CFG's float32 the CPU's program is
  the card's, as the flash kernels take bf16 and fp16 only;
- the wall ms of one `step` (median of STEPS after a warm-up step, the
  device synchronised around each), and its ratio to the SPMD row's;
- the analytic tick ratio (mb + pp - 1) / mb.

Every stage of a pipeline mesh runs on one device, one after another (the
port's pipeline departs from the reference here: ROADMAP.md, Queue 1
item 4), so
the wall ratio measures serial stages and micro-batching overhead, not
the bubbles of stages on separate devices.

Usage: python3 -m paddle_tpu_torch.tools.pipeline_tax [--device cpu]
[--workers N] (prints a markdown table; the card unless --device cpu is
given; N capture processes, default one fewer than the host's cores, 0
to capture in this process).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import optimizer, pir

CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=8,
           num_attention_heads=4, num_key_value_heads=4, vocab_size=512,
           max_position_embeddings=256)
BATCH, SEQ = 8, 128
STEPS = 4
ROWS = ((2, 4), (4, 8), (4, 2))
SCHEDULES = ("FThenB", "1F1B", "VPP", "ZB")


def _model(device):
    paddle.seed(0)
    return paddle.models.llama_tiny(device=device, **CFG)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _wall_ms(run_step, device, steps=STEPS):
    """Median ms of one step after one warm-up step."""
    run_step()
    _sync(device)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run_step()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _flops(fn, *args):
    """CostModel flops of fn's captured program, or None."""
    try:
        prog, _ = pir.capture(fn, *args, name="step")
        return pir.CostModel().analyze(prog).flops
    except Exception as e:  # noqa: BLE001 — the column reads n/a
        print(f"capture failed: {type(e).__name__}: {str(e)[:160]}",
              file=sys.stderr)
        return None


def _spmd_trainer(pp, device):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel.spmd import DP_ONLY_RULES, SpmdTrainer
    model = _model(device)
    mesh = dist.ProcessMesh(shape=[pp], dim_names=["dp"], device=device)
    return SpmdTrainer(model, optimizer.AdamW(
        1e-3, parameters=model.parameters()), mesh, DP_ONLY_RULES)


def _runner(schedule, pp, mb, device):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel.llama_pipeline import LlamaPipeRunner
    model = _model(device)
    mesh = dist.ProcessMesh(shape=[pp], dim_names=["pp"], device=device)
    return LlamaPipeRunner(model, mesh, mb, optimizer=optimizer.AdamW(
        1e-3, parameters=model.parameters()), schedule=schedule)


def _ids(device):
    return torch.zeros(BATCH, SEQ, dtype=torch.int64, device=device)


def step_ms(kind, pp, mb, device):
    """Wall ms of one step of SpmdTrainer (kind "spmd") or of
    LlamaPipeRunner under schedule `kind`."""
    ids = _ids(device)
    if kind == "spmd":
        tr = _spmd_trainer(pp, device)
        return _wall_ms(lambda: tr.step((ids, ids), rng_key=0), device)
    runner = _runner(kind, pp, mb, device)
    return _wall_ms(lambda: runner.step(ids, ids), device)


def step_flops(kind, pp, mb):
    """CostModel flops of the captured gradient computation of one step,
    on the CPU."""
    ids = _ids("cpu")
    if kind == "spmd":
        model = _model("cpu")
        names = [k for k, _ in model.named_parameters()]

        def grads(*flat):
            ps = [p.requires_grad_() for p in flat[:-1]]
            with torch.enable_grad():
                loss, _ = torch.func.functional_call(
                    model, dict(zip(names, ps)), (flat[-1],),
                    {"labels": flat[-1]})
                return (loss,) + torch.autograd.grad(loss, ps)

        return _flops(grads, *[p.detach() for p in model.parameters()], ids)
    runner = _runner(kind, pp, mb, "cpu")
    keys = [list(g) for _, g in runner._groups()]
    flat = [v.detach() for _, g in runner._groups() for v in g.values()]

    def grads(*leaves):
        it = iter(leaves[:-1])
        trees = [{k: next(it).requires_grad_() for k in ks} for ks in keys]
        tokens = leaves[-1]
        with torch.enable_grad():
            if runner._grads_fn is not None:
                return tuple(runner._grads_fn(*trees, tokens, tokens))
            loss = runner._loss_fn(*trees, tokens, tokens)
            ps = [v for t in trees for v in t.values()]
            return (loss,) + torch.autograd.grad(loss, ps)

    return _flops(grads, *flat, ids)


def _flops_job(job):
    """A capture process's job: (kind, pp, mb, CFG, BATCH, SEQ)."""
    global CFG, BATCH, SEQ
    kind, pp, mb, CFG, BATCH, SEQ = job
    torch.set_num_threads(1)
    return step_flops(kind, pp, mb)


def _jobs():
    out = []
    for pp, mb in ROWS:
        out.append(("spmd", pp, mb))
        out += [(s, pp, mb) for s in (SCHEDULES if mb >= pp
                                      else ("1F1B", "ZB"))]
    return out


class FlopsCaptures:
    """The flops column's captures, one a row, in `workers` spawned
    processes (None: one fewer than the host's cores; 0: in this process,
    on demand). They take host time only, so a caller may start them
    ahead of other work on the device; the longest captures (most stages
    x micro-batches) start first."""

    def __init__(self, workers=None):
        if workers is None:
            workers = max(1, (os.cpu_count() or 2) - 1)
        jobs = sorted(_jobs(), key=lambda j: -j[1] * j[2])
        self._pool = None
        self._results = {}
        if workers:
            self._pool = ProcessPoolExecutor(
                min(workers, len(jobs)), mp_context=get_context("spawn"))
            self._results = {j: self._pool.submit(
                _flops_job, j + (CFG, BATCH, SEQ)) for j in jobs}

    def get(self, kind, pp, mb):
        if self._pool is None:
            return step_flops(kind, pp, mb)
        return self._results[(kind, pp, mb)].result()

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)


def run(device, workers=None, captures=None):
    """Rows of (program, pp, mb, flops or None, wall ms, wall ratio, tick
    ratio) and the failures. The steps are timed one after another; the
    flops come from `captures` (a FlopsCaptures, started here after the
    timed steps when None)."""
    rows, failures = [], []
    base_ms = None
    for kind, pp, mb in _jobs():
        try:
            ms = step_ms(kind, pp, mb, device)
        except Exception as e:  # noqa: BLE001 — reported, not fatal
            failures.append(f"{kind} pp={pp} FAILED: "
                            f"{type(e).__name__}: {str(e)[:200]}")
            continue
        if kind == "spmd":
            base_ms = ms
        name = f"SpmdTrainer dp={pp}" if kind == "spmd" \
            else f"{kind} pp={pp}"
        rows.append((name, pp, mb, (kind, pp, mb), ms, ms / base_ms,
                     1.0 if kind == "spmd" else (mb + pp - 1) / mb))
    own = captures is None
    captures = FlopsCaptures(workers) if own else captures
    try:
        rows = [r[:3] + (captures.get(*r[3]),) + r[4:] for r in rows]
    finally:
        if own:
            captures.close()
    return rows, failures


def table(rows, device):
    where = (torch.cuda.get_device_name() if torch.device(device).type
             == "cuda" else "cpu")
    out = [f"pipeline tax on {where} (every stage on this one device, run "
           f"one after another: the wall ratio measures serial stages and "
           f"micro-batching, not bubbles across devices)",
           "| program | process ids | microbatches | CostModel GFLOPs/step "
           "| wall ms/step | wall vs SPMD | analytic tick ratio |",
           "|---|---|---|---|---|---|---|"]
    for name, pp, mb, fl, ms, ratio, ticks in rows:
        gf = "n/a" if fl is None else f"{fl / 1e9:.3f}"
        out.append(f"| {name} | {pp} | {mb} | {gf} | {ms:.2f} | "
                   f"{ratio:.2f}x | {ticks:.2f}x |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the steps run: cuda (default) or cpu")
    ap.add_argument("--workers", type=int, default=None,
                    help="capture processes for the flops column (default "
                         "one fewer than the cores; 0: in this process)")
    args = ap.parse_args(argv)
    rows, failures = run(args.device, args.workers)
    print(table(rows, args.device))
    for f in failures:
        print(f"FAILURE: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""StepWatch: training-loop telemetry hook.

reference capability: python/paddle/profiler/timer.py Benchmark (ips /
step cost) grown into the always-on telemetry the ROADMAP's production
system needs: per-step wall time (with optional phase breakdown), online
tokens/s + MFU, loss / grad-norm gauges, and a JSONL step log whose rows
carry the same round/provenance fields as the bench ledger
(.bench_tpu_wins.jsonl), so training evidence and bench evidence are one
schema.

Zero-cost when disabled: step() checks the registry's enable flag first
and returns — the 50-step smoke-loop overhead guard in
tests/test_observability.py pins this.

Port: a copy of `paddle_tpu/observability/stepwatch.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import json
import os
import time

from . import metrics as _metrics
from .catalog import metric as _metric

__all__ = ["StepWatch", "current_round"]


def current_round(repo_dir=None):
    """Round number from the PROGRESS.jsonl heartbeat in `repo_dir` (or
    the working directory); None if unavailable."""
    try:
        path = os.path.join(repo_dir or os.getcwd(), "PROGRESS.jsonl")
        last = None
        with open(path) as f:
            for line in f:
                if line.strip():
                    last = line
        obj = json.loads(last)
        return obj.get("round") if isinstance(obj, dict) else None
    except Exception:
        return None


class StepWatch:
    """
    sw = StepWatch(tokens_per_step=batch*seq,
                   flops_per_token=6*n_params, peak_flops=197e12,
                   jsonl_path="steps.jsonl", run_name="llama_1.3b")
    sw.start()
    for batch in loader:
        with sw.phase("data"):
            x, y = next(it)
        loss = train_step(x, y)             # rest of the step is "compute"
        sw.step(loss=float(loss))
    """

    def __init__(self, tokens_per_step=None, flops_per_token=None,
                 peak_flops=None, jsonl_path=None, run_name="train",
                 round=None, provenance=None, log_every=1):
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.jsonl_path = jsonl_path
        self.run_name = run_name
        self.round = round if round is not None else current_round()
        self.provenance = provenance
        self.log_every = max(int(log_every), 1)
        self._registry = _metrics.get_registry()
        self._m_step = _metric("train_step_seconds")
        self._m_tokens = _metric("train_tokens_total")
        self._m_loss = _metric("train_loss")
        self._m_gnorm = _metric("train_grad_norm")
        self._m_tps = _metric("train_tokens_per_s")
        self._m_mfu = _metric("train_mfu")
        self._i = 0
        self._t_last = None
        self._phases = {}
        self._durs = []

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._t_last = time.perf_counter()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        return False

    # -- phase breakdown -----------------------------------------------------
    class _Phase:
        __slots__ = ("_sw", "_name", "_t0")

        def __init__(self, sw, name):
            self._sw = sw
            self._name = name

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._sw._phases[self._name] = (
                self._sw._phases.get(self._name, 0.0)
                + time.perf_counter() - self._t0)
            return False

    def phase(self, name):
        """Accumulate a named slice of the current step (data/compute/...)."""
        if not self._registry.enabled:
            from .tracing import _NOOP
            return _NOOP
        return StepWatch._Phase(self, name)

    # -- per-step hook -------------------------------------------------------
    def step(self, loss=None, grad_norm=None, tokens=None):
        """Close the current step. Call AFTER the host has synced (e.g.
        after float(loss)) or the 'step time' is only dispatch time."""
        if not self._registry.enabled:
            return None
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return None
        dt = now - self._t_last
        self._t_last = now
        self._i += 1
        ntok = tokens if tokens is not None else self.tokens_per_step
        row = self._emit(self._i, dt, ntok, loss, grad_norm,
                         breakdown=self._phases or None)
        self._phases = {}
        return row

    def record_run(self, steps, seconds, tokens=None, loss=None,
                   grad_norm=None):
        """Aggregate entry for an externally timed region (bench.py times
        its loop without per-step syncs; feeding those per-step would
        record dispatch time, not step time)."""
        if not self._registry.enabled or steps <= 0:
            return None
        dt = seconds / steps
        ntok = (tokens / steps if tokens is not None
                else self.tokens_per_step)
        row = None
        for _ in range(int(steps)):
            self._i += 1
            row = self._emit(self._i, dt, ntok, loss, grad_norm,
                             aggregated=True)
        return row

    def _emit(self, i, dt, ntok, loss, grad_norm, breakdown=None,
              aggregated=False):
        self._durs.append(dt)
        del self._durs[:-1000]
        self._m_step.observe(dt)
        row = {"event": "step", "run": self.run_name, "step": i,
               "step_time_s": dt, "round": self.round,
               "recorded_unix": int(time.time())}
        if aggregated:
            row["aggregated"] = True
        if self.provenance:
            row["provenance"] = self.provenance
        if breakdown:
            row["breakdown_s"] = {k: round(v, 6)
                                  for k, v in breakdown.items()}
        if ntok:
            tps = ntok / dt
            self._m_tokens.inc(ntok)
            self._m_tps.set(tps)
            row["tokens_per_s"] = tps
            if self.flops_per_token and self.peak_flops:
                mfu = self.flops_per_token * tps / self.peak_flops
                self._m_mfu.set(mfu)
                row["mfu"] = round(mfu, 6)
        if loss is not None:
            self._m_loss.set(loss)
            row["loss"] = float(loss)
        if grad_norm is not None:
            self._m_gnorm.set(grad_norm)
            row["grad_norm"] = float(grad_norm)
        if self.jsonl_path and (i % self.log_every == 0):
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    # -- reporting -----------------------------------------------------------
    def summary(self):
        if not self._durs:
            return {"steps": 0}
        n = len(self._durs)
        avg = sum(self._durs) / n
        out = {"steps": self._i, "avg_step_time_s": avg}
        if self.tokens_per_step:
            out["tokens_per_s"] = self.tokens_per_step / avg
            if self.flops_per_token and self.peak_flops:
                out["mfu"] = (self.flops_per_token * out["tokens_per_s"]
                              / self.peak_flops)
        return out

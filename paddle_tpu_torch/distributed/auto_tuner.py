"""Auto-tuner: search dp/mp/pp/sharding/micro-batch/remat configurations.
reference: paddle_tpu/distributed/auto_tuner.py (`TunerConfig` :34,
`AutoTuner`), itself after python/paddle/distributed/auto_tuner/ (tuner.py,
prune.py, search.py).

Candidates are mesh factorizations of the devices; pruning combines the
reference's divisibility rules with an analytic memory model (params,
grads and optimizer state under the chosen ZeRO stage, activations under
remat), and ranking an analytic step-time model (FLOPs over the peak rate,
collective bytes over the link's bandwidth, pipeline bubble). A
`measure_fn` hook times real trials; search_once()/add_cfg() keep the
reference's protocol. The model is the reference's; only the defaults of
the card's memory, peak rate and link bandwidth are the H100's.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ["AutoTuner", "TunerConfig"]

# one H100 SXM (NVIDIA data sheet): dense bf16 tensor-core FLOP/s, and
# NVLink 4's bandwidth each way (18 links of 25 GB/s)
H100_PEAK_FLOPS = 989e12
H100_NVLINK_BYTES_PER_S = 4.5e11


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _card_default(value, what, read):
    if value is not None:
        return float(value)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"TunerConfig: no CUDA device to take {what} from; pass it")
    return float(read())


class TunerConfig:
    """User knobs (reference tuner_cfg keys kept where they exist).

    The reference's defaults are a TPU's. Here, left None: `hbm_bytes` is
    the card's total memory (torch.cuda.get_device_properties(0)),
    `peak_flops` the H100 SXM's dense bf16 peak, 989e12 FLOP/s, and
    `ici_bandwidth` NVLink 4's 4.5e11 bytes/s each way: the figures of an
    NVIDIA H100 80GB HBM3 at its 700 W power limit (a card set below it
    runs slower under load). Without a CUDA device each must be given."""

    def __init__(self, num_devices, global_batch_size, num_layers,
                 hidden_size, num_attention_heads, seq_length, vocab_size,
                 hbm_bytes=None, peak_flops=None, ici_bandwidth=None,
                 dtype_bytes=2, max_mp=None, max_pp=None,
                 candidates=None, task_limit=100):
        self.num_devices = num_devices
        self.global_batch_size = global_batch_size
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.hbm_bytes = _card_default(
            hbm_bytes, "hbm_bytes",
            lambda: torch.cuda.get_device_properties(0).total_memory)
        self.peak_flops = _card_default(peak_flops, "peak_flops",
                                        lambda: H100_PEAK_FLOPS)
        self.ici_bandwidth = _card_default(ici_bandwidth, "ici_bandwidth",
                                           lambda: H100_NVLINK_BYTES_PER_S)
        self.dtype_bytes = dtype_bytes
        self.max_mp = max_mp or num_devices
        self.max_pp = max_pp or num_devices
        self.candidates = candidates or {}
        self.task_limit = task_limit

    # approximate decoder parameter count (attention + MLP + embeddings)
    def n_params(self):
        h, L, v = self.hidden_size, self.num_layers, self.vocab_size
        return L * (12 * h * h) + 2 * v * h


class AutoTuner:
    """Grid search with pruning over (dp, mp, pp, sharding_stage,
    micro_batch_size, recompute)."""

    PRUNE_RULES = ("mp", "pp", "mbs", "sharding", "memory")

    def __init__(self, tuner_cfg: TunerConfig, measure_fn=None):
        self.cfg = tuner_cfg
        self.measure_fn = measure_fn
        self.history_cfgs = []
        self.pruned_cfgs = []
        self._queue = self._build_candidates()
        self._issued = 0  # queue position of the next un-returned candidate
        self.cur_task_id = 0

    # -- candidate generation (reference: utils.default_candidates) --------
    def _build_candidates(self):
        c = self.cfg
        cand = c.candidates
        mps = cand.get("mp_degree") or [
            d for d in _divisors(c.num_devices) if d <= c.max_mp]
        pps = cand.get("pp_degree") or [
            d for d in _divisors(c.num_devices) if d <= c.max_pp]
        stages = cand.get("sharding_stage") or [0, 1, 2, 3]
        mbss = cand.get("micro_batch_size") or _divisors(
            c.global_batch_size)
        remats = cand.get("use_recompute") or [False, True]

        out = []
        for mp, pp, stage, mbs, remat in itertools.product(
                mps, pps, stages, mbss, remats):
            if c.num_devices % (mp * pp) != 0:
                continue
            rest = c.num_devices // (mp * pp)
            shd = rest if stage > 0 else 1
            dp = rest // shd
            cfgd = dict(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                        sharding_degree=shd, sharding_stage=stage,
                        micro_batch_size=mbs, use_recompute=remat)
            reason = self._prune(cfgd)
            if reason:
                cfgd["pruned_reason"] = reason
                self.pruned_cfgs.append(cfgd)
                continue
            cfgd["estimated_step_time"] = self._cost(cfgd)
            out.append(cfgd)
        out.sort(key=lambda d: d["estimated_step_time"])
        return out[: c.task_limit]

    # -- pruning (reference: prune.py registered rules) --------------------
    def _prune(self, d):
        c = self.cfg
        mp, pp = d["mp_degree"], d["pp_degree"]
        dp, shd = d["dp_degree"], d["sharding_degree"]
        mbs = d["micro_batch_size"]
        if c.num_attention_heads % mp or c.hidden_size % mp:
            return f"mp {mp} does not divide heads/hidden"  # prune_by_mp
        if c.num_layers % pp:
            return f"pp {pp} does not divide layers"        # prune_by_pp
        if dp == 0 or c.global_batch_size % (dp * max(shd, 1)):
            return "global batch not divisible by dp*sharding"
        local_batch = c.global_batch_size // (dp * max(shd, 1))
        if local_batch % mbs:
            return f"micro batch {mbs} does not divide local batch"
        n_micro = local_batch // mbs
        if pp > 1 and n_micro < pp:
            return f"pipeline needs microbatches >= pp ({n_micro} < {pp})"
        mem = self._memory_bytes(d)
        if mem > c.hbm_bytes:
            return (f"memory model {mem / 1e9:.1f}GB exceeds HBM "
                    f"{c.hbm_bytes / 1e9:.1f}GB")  # prune_by_memory
        return None

    # -- analytic per-device memory model ----------------------------------
    def _memory_bytes(self, d):
        c = self.cfg
        P = c.n_params()
        mp, pp, shd = d["mp_degree"], d["pp_degree"], d["sharding_degree"]
        stage = d["sharding_stage"]
        shard_p = P / (mp * pp)
        params = shard_p * c.dtype_bytes / (shd if stage >= 3 else 1)
        grads = shard_p * c.dtype_bytes / (shd if stage >= 2 else 1)
        opt = shard_p * 8 / (shd if stage >= 1 else 1)  # fp32 m+v
        mbs, s, h = d["micro_batch_size"], c.seq_length, c.hidden_size
        layers_local = c.num_layers // pp
        if d["use_recompute"]:
            act_per_layer = 2 * s * h * c.dtype_bytes        # boundary only
        else:
            act_per_layer = 34 * s * h * c.dtype_bytes / 2   # full residuals
        live_mb = min(2 * pp - 1, max(
            c.global_batch_size // (d["dp_degree"] * max(shd, 1) * mbs), 1)) \
            if pp > 1 else 1
        acts = mbs * layers_local * act_per_layer * live_mb
        return params + grads + opt + acts

    # -- analytic step-time cost (ranking only; relative, seconds-ish) -----
    def _cost(self, d):
        c = self.cfg
        P = c.n_params()
        tokens = c.global_batch_size * c.seq_length
        flops = 6.0 * P * tokens
        if d["use_recompute"]:
            flops *= 4 / 3          # one extra forward
        compute = flops / (c.num_devices * c.peak_flops * 0.5)
        # mp all-reduces: ~4 activations of (tokens/dp/shd, h) per layer
        mp, pp = d["mp_degree"], d["pp_degree"]
        dp, shd = d["dp_degree"], d["sharding_degree"]
        comm = 0.0
        if mp > 1:
            bytes_mp = (4 * c.num_layers
                        * (tokens / (dp * max(shd, 1))) * c.hidden_size
                        * c.dtype_bytes * 2 * (mp - 1) / mp)
            comm += bytes_mp / c.ici_bandwidth
        if dp * max(shd, 1) > 1:
            # grad reduce: 2 bytes/param ring all-reduce (or reduce-scatter)
            comm += (P / (mp * pp)) * c.dtype_bytes * 2 / c.ici_bandwidth
        bubble = 0.0
        if pp > 1:
            local_batch = c.global_batch_size // (dp * max(shd, 1))
            m = max(local_batch // d["micro_batch_size"], 1)
            bubble = compute * (pp - 1) / (m + pp - 1)
        return compute + comm + bubble

    # -- reference search protocol -----------------------------------------
    def search_once(self):
        """Next un-run candidate (reference: tuner.py search_once), or None.
        Issued candidates are tracked by queue position — measured/extra
        keys added by the caller never affect the walk."""
        if self._issued >= len(self._queue):
            return None
        cfgd = self._queue[self._issued]
        self._issued += 1
        self.cur_task_id += 1
        return dict(cfgd)

    def add_cfg(self, cfg):
        """Record a run config (+ measured metrics if the caller added them)."""
        self.history_cfgs.append(
            {k: v for k, v in cfg.items() if k != "estimated_step_time"}
            | {"estimated_step_time": cfg.get("estimated_step_time")})

    def search_all(self):
        """All surviving candidates, best-estimated first."""
        return [dict(d) for d in self._queue]

    def tune(self, max_trials=None):
        """Full loop: measure each candidate with measure_fn (step-time
        seconds; may raise to mark infeasible) and return the best."""
        best = None
        trials = 0
        while True:
            if max_trials and trials >= max_trials:
                break  # before search_once: don't pop-and-drop a candidate
            cur = self.search_once()
            if cur is None:
                break
            trials += 1
            if self.measure_fn is not None:
                try:
                    cur["measured_step_time"] = float(self.measure_fn(cur))
                except Exception as e:  # infeasible (OOM/compile): record
                    cur["error"] = f"{type(e).__name__}: {e}"
                    self.add_cfg(cur)
                    continue
            self.add_cfg(cur)
            key = cur.get("measured_step_time",
                          cur.get("estimated_step_time"))
            if best is None or key < best[0]:
                best = (key, cur)
        return best[1] if best else None

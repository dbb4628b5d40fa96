"""Where the time of the serving engine's decode tile and prefill chunk goes
on the card.

    python3 -m paddle_tpu_torch.tools.profile_serving

Builds llama_7b in bf16 at full width and depth with random weights from
seed(0) and a ContinuousBatchingEngine at chip_smoke.py's engine knobs
(8 lanes, blocks of 16, 128 blocks a sequence, 1,040 blocks), reserves
blocks for 8 lanes of 1,100 tokens and puts every lane at position 1,024.
Then it times (CUDA events, median of 5) and traces with torch.profiler:
one decode tile of K=4 replayed from its CUDA graph, one decode step run
eagerly, and one prefill chunk of 512 tokens. For each it prints the
device time, the summed kernel time and the kernels that take the most of
it. Needs one CUDA device.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import ContinuousBatchingEngine

ENGINE = dict(max_batch=8, block_size=16, max_blocks_per_seq=128,
              num_blocks=1040, prefill_buckets=(64, 128, 256, 512),
              prefill_chunk=512, decode_steps=4)
CONTEXT = 1024
TOP = 12


def _device_us(event):
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0))


def median_ms(fn, reset, reps=5):
    """Median device time (CUDA events) of fn() over `reps` runs after one
    warm-up, `reset()` before each."""
    times = []
    for _ in range(reps + 1):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def _report(name, fn, reset):
    ms = median_ms(fn, reset)
    reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    total = sum(_device_us(e) for e in events)
    print(f"{name}: {ms:.3f} ms (CUDA events, median of 5); kernels "
          + (f"{total / 1e3:.3f} ms, {sum(e.count for e in events)} launches"
             if events else "not measured (the profiler saw no kernel)"))
    for e in sorted(events, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms {_device_us(e) / total:6.1%}"
              f" x{e.count:<6d} {e.key[:100]}")


def lane_state(eng, vocab):
    """Reserve blocks for every lane of `eng` (CONTEXT + 76 tokens) and
    return reset(), which puts every lane, alive and greedy, at position
    CONTEXT with a token drawn from RandomState(0)."""
    B, mb = eng.max_batch, eng.max_blocks_per_seq
    tables = torch.full((B, mb), eng.pool.scratch_block, dtype=torch.int64)
    for lane in range(B):
        t = eng.pool.ensure(lane, CONTEXT + 76)
        tables[lane, :len(t)] = torch.as_tensor(t)
    d = eng._dev
    state = dict(tables=tables.to(eng.device),
                 lens=torch.full_like(d["lens"], CONTEXT),
                 toks=torch.as_tensor(np.random.RandomState(0).randint(
                     0, vocab, B), device=eng.device),
                 alive=torch.ones_like(d["alive"]),
                 rem=torch.full_like(d["rem"], 64),
                 eos=torch.full_like(d["eos"], -1))

    def reset():
        for k, v in state.items():
            d[k].copy_(v)
    return reset


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_serving: needs a CUDA device")
    pt.seed(0)
    model = pt.models.llama_7b(dtype="bfloat16", device="cuda").eval()
    eng = ContinuousBatchingEngine(model, **ENGINE)
    reset = lane_state(eng, model.config.vocab_size)
    ids = torch.as_tensor(np.random.RandomState(1).randint(
        0, model.config.vocab_size, (1, 512)), device="cuda")
    table = eng._dev["tables"]
    with torch.no_grad():
        reset()
        tile = eng._capture(False, ENGINE["decode_steps"])
        B = eng.max_batch
        _report(f"decode tile K={ENGINE['decode_steps']} x {B} lanes, greedy, "
                f"graph replay", tile.graph.replay, reset)
        _report(f"decode step x {B} lanes, greedy, eager",
                lambda: eng._decode_tile(False, 1), reset)
        _report("prefill chunk of 512 tokens, eager",
                lambda: eng._prefill_chunk(ids, 0, 511, table[0]),
                reset)
    print("device:", torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()

"""Where the time of one `generate` call goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_generate

Builds llama_7b in bf16 at full width and depth with random weights from
seed(0), warms up, then runs two greedy calls on 4 prompts of 512 tokens:
prefill alone (1 new token) and the whole call (32 new tokens). Each is
timed untraced (host clock around a synchronized call), then traced with
torch.profiler. For each it prints the untraced wall time, the summed
kernel time and the device's busy share (summed kernel time over the
untraced wall time: one stream, so kernels do not overlap), and the kernels
that take the most device time. Needs one CUDA device.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import paddle_tpu_torch as pt
from paddle_tpu_torch import generation

BATCH, PROMPT, NEW = 4, 512, 32
TOP = 12


def _device_us(event):
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0))


def _report(name, prof, wall_s):
    # kernels only: the host-side ops that launched them carry the same
    # device time and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    total_us = sum(_device_us(e) for e in events)
    if not events:
        print(f"{name}: wall {wall_s * 1e3:.1f} ms; device time not "
              f"measured (the profiler saw no kernel)")
        return
    print(f"{name}: wall {wall_s * 1e3:.1f} ms, kernels {total_us / 1e3:.1f} "
          f"ms, device busy {total_us / 1e6 / wall_s:.1%}, "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms {_device_us(e) / total_us:6.1%}"
              f" x{e.count:<6d} {e.key[:110]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_generate: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    pt.seed(0)
    model = pt.models.llama_7b(dtype="bfloat16", device="cuda").eval()
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, model.config.vocab_size, (BATCH, PROMPT)), device="cuda")
    generation.generate(model, ids, max_new_tokens=NEW)      # warm-up
    for name, n in (("prefill (1 new token)", 1),
                    (f"generate ({NEW} new tokens)", NEW)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generation.generate(model, ids, max_new_tokens=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            generation.generate(model, ids, max_new_tokens=n)
            torch.cuda.synchronize()
        _report(f"{name}, b{BATCH} s{PROMPT}", prof, wall)


if __name__ == "__main__":
    main()

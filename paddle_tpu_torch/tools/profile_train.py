"""Where the time of one training step goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_train [--config llama_1.3b]

Builds the config as tools/train_llama.py does (llama_1.3b: batch 8,
sequence 2048, per-layer remat, chunked LM loss, AdamW) and runs two
warm-up steps. Then, for one step each:
- untraced: the host clock around a synchronized step, and CUDA events
  around its three phases (forward, backward, AdamW update);
- traced with torch.profiler: the summed kernel time, the device's busy
  share (summed kernel time over the untraced step time: one stream, so
  kernels do not overlap), the kernels that take the most device time, and
  kernel time by class: the flash kernels K1, K3 and K4, the matrix
  products (cuBLAS), elementwise kernels, reductions, copies, and the
  rest.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .profile_generate import _device_us, _report
from .train_llama import TrainStep, llama_ladder, loss_chunk_mb_for

# kernel classes, by a piece of the kernel's name; the first match wins
CLASSES = (("K1 flash_fwd", ("flash_fwd_kernel",)),
           ("K3 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
           ("K4 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
           ("matrix products", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
           ("copies", ("copy", "cat", "stack")),
           ("elementwise", ("elementwise",)),
           ("reductions", ("reduce", "softmax", "norm")))


def _classify(name):
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _by_class(prof):
    totals: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and _device_us(e) > 0:
            cls = _classify(e.key)
            us, n = totals.get(cls, (0.0, 0))
            totals[cls] = (us + _device_us(e), n + e.count)
    all_us = sum(us for us, _ in totals.values()) or 1.0
    print("kernel time by class:")
    for cls, (us, n) in sorted(totals.items(), key=lambda x: -x[1][0]):
        print(f"  {us / 1e3:9.3f} ms {us / all_us:6.1%} x{n:<6d} {cls}")


def _phases(train, n):
    """Device time of the forward, the backward and the update of step n,
    on CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = train.forward()
    ev[1].record()
    loss.backward()
    ev[2].record()
    train.update(n)
    ev[3].record()
    ev[3].synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1])
            for i, name in enumerate(("forward", "backward", "update"))}


def main():
    ladder = {row[0]: row for row in llama_ladder()}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="llama_1.3b", choices=sorted(ladder))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name, cfg, batch, seq, _, remat = ladder[args.config]
    train = TrainStep(cfg, batch, seq, remat,
                      loss_chunk_mb=loss_chunk_mb_for(name), device="cuda")
    for n in (1, 2):
        train.step(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.step(3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = _phases(train, 4)
    print(f"{name} b{batch} s{seq}: untraced step {wall * 1e3:.1f} ms; "
          f"phases on CUDA events (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.step(5)
        torch.cuda.synchronize()
    _report(f"training step, {name} b{batch} s{seq}", prof, wall)
    _by_class(prof)


if __name__ == "__main__":
    main()

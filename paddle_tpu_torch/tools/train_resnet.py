"""The ResNet training step: the counterpart of bench.py's `_bench_resnet`
(:253-287), with `_functional_train_setup` (:210) and `_time_train`
(:241); and the same step for any model of vision/models (`zoo_config`).

    python3 -m paddle_tpu_torch.tools.train_resnet [--steps 8] [--device cuda]
        [--model mobilenet_v2]

On CUDA (the default) it trains bench.py's configuration: ResNet-50 (1000
classes) with its parameters and batch-norm buffers cast to bf16, batch
64, 224 x 224 images. With `--device cpu` it trains bench.py's CPU
configuration: resnet18 with 10 classes, batch 2, 32 x 32, in float32.
Either way: weights from seed(0), Momentum(0.1, momentum=0.9), the
cross-entropy of the logits, x = RandomState(0).randn(batch, 3, hw, hw)
and y = randint(0, classes, (batch,)) from the same RandomState, the same
batch every step, one warm-up step, then `steps` timed steps. Prints one
JSON line with the result of `run_one`. With `--model NAME` it trains
`zoo_config(NAME, device)` instead: on CUDA the model with 1000 classes at
its published input size (224 x 224; 299 x 299 for inception_v3), batch
64, bf16; on the CPU with 10 classes at a small size (64 x 64; 75 x 75
for inception_v3, the smallest it takes), batch 2, float32.

A model whose output is a tuple (GoogLeNet's main head and its two aux
heads) is trained on the loss of its first element, the main head: the
reference has no recipe that weighs the aux heads in.

The step runs the model eagerly in training mode, so each batch norm
updates its running statistics in place, as the reference's eager forward
does; bench.py's functional step leaves them where they were. Losses and
parameters do not depend on them: training normalizes by the batch's own
statistics.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import optimizer
from ..framework import resolve_device, seed
from ..framework.dtypes import convert_dtype
from ..nn import Linear
from ..nn import functional as F
from ..nn.layer.conv import _ConvNd
from ..nn.layer.norm import _BatchNormBase
from ..vision import models
from .train_llama import _sync, device_report, peak_flops, time_steps

__all__ = ["BenchConfig", "bench_config", "zoo_config", "TrainStep",
           "run_one", "conv_linear_macs"]

LR = 0.1
MOMENTUM = 0.9


class BenchConfig(NamedTuple):
    variant: str          # bench.py's resnet_variant
    ctor: Callable        # the model's constructor, given device=
    batch: int
    hw: int               # images are hw x hw
    steps: int
    dtype: str
    classes: int


def bench_config(device) -> BenchConfig:
    """bench.py's configuration for `device` (:264-269)."""
    if torch.device(device).type == "cuda":
        return BenchConfig("resnet50_224", models.resnet50, 64, 224, 8,
                           "bfloat16", 1000)
    return BenchConfig("resnet18_32_cpu",
                       functools.partial(models.resnet18, num_classes=10),
                       2, 32, 2, "float32", 10)


# input sizes other than 224 x 224: on the card the published one, on the
# CPU the smallest that the model takes (the others run at 64 x 64)
_ZOO_HW = {"inception_v3": 299}
_ZOO_HW_CPU = {"inception_v3": 75}


def zoo_config(name, device) -> BenchConfig:
    """The training configuration of vision/models' `name` on `device`:
    on CUDA 1000 classes at its published input size, batch 64, bf16,
    8 steps; on the CPU 10 classes at a small size, batch 2, float32, 2
    steps."""
    ctor = getattr(models, name)
    if torch.device(device).type == "cuda":
        hw = _ZOO_HW.get(name, 224)
        return BenchConfig(f"{name}_{hw}", ctor, 64, hw, 8, "bfloat16",
                           1000)
    hw = _ZOO_HW_CPU.get(name, 64)
    return BenchConfig(f"{name}_{hw}_cpu",
                       functools.partial(ctor, num_classes=10), 2, hw, 2,
                       "float32", 10)


def conv_linear_macs(model, x):
    """The multiply-adds of one forward of `x` through the model's
    convolutions and linear layers, counted from their output shapes (run
    in eval mode without grad, so no running statistic moves)."""
    macs = []

    def hook(m, _inp, out):
        per_out = m.weight[0].numel() if isinstance(m, _ConvNd) \
            else m.in_features
        macs.append(out.numel() * per_out)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (_ConvNd, Linear))]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return sum(macs)


class TrainStep:
    """The model of `cfg.ctor` built in float32 from seed(0), its
    parameters and buffers cast to `cfg.dtype` (bench.py's `to_bf16`),
    Momentum(0.1, 0.9), and bench.py's images and labels from
    RandomState(0). `step(n)` runs the forward in training mode, the
    backward and the update in place, and returns the loss as a float32
    device tensor, with no host sync. Of a tuple of outputs (GoogLeNet's
    main and aux heads) the loss takes the first, the main head's.
    `flops_per_step` counts 2 x the multiply-adds of the convolutions and
    linear layers x 3 (forward and backward)."""

    def __init__(self, cfg: BenchConfig, device=None):
        device = resolve_device(device)
        dtype = convert_dtype(cfg.dtype)
        seed(0)
        self.model = cfg.ctor(device=device)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self.model.to(dtype)
        self.opt = optimizer.Momentum(LR, momentum=MOMENTUM,
                                      parameters=self.model.parameters())
        rng = np.random.RandomState(0)
        self.x = torch.as_tensor(rng.randn(cfg.batch, 3, cfg.hw, cfg.hw),
                                 dtype=dtype, device=device)
        self.y = torch.as_tensor(rng.randint(0, cfg.classes, (cfg.batch,)),
                                 device=device)
        self.flops_per_step = 6.0 * cfg.batch * conv_linear_macs(
            self.model, self.x[:1])

    def step(self, n):
        out = self.model(self.x)
        if isinstance(out, tuple):
            out = out[0]
        loss = F.cross_entropy(out, self.y)
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        return loss.detach()


def run_one(cfg: BenchConfig, steps=None, device=None):
    """One warm-up step, then `steps` (default `cfg.steps`) timed steps.
    Returns bench.py's keys (resnet_images_per_s, resnet_batch,
    resnet_loss, resnet_variant) and
    resnet_mfu (flops_per_step over the step time and the card's peak;
    None without one), the step time in ms, the per-step losses (warm-up
    first), each timed step's flash-kernel launches, whether every batch
    norm's running statistics are finite after the steps and the largest
    |value| of the stem batch norm's running mean (0 before any training
    forward), the peak device memory and the seconds of set-up, warm-up
    and the timed steps."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    train = TrainStep(cfg, device)
    _sync(device)
    setup = time.perf_counter() - t0
    steps = steps or cfg.steps
    losses, launches, warmup, dt = time_steps(train.step, steps, device)
    peak = peak_flops(device)
    stats = [b for k, b in train.model.named_buffers()
             if k.endswith(("_mean", "_variance"))]
    stem = next((m for m in train.model.modules()
                 if isinstance(m, _BatchNormBase)), None)
    return {"resnet_images_per_s": cfg.batch * steps / dt,
            "resnet_batch": cfg.batch, "resnet_loss": losses[-1],
            "resnet_variant": cfg.variant,
            "resnet_mfu": (None if peak is None else
                           train.flops_per_step * steps / dt / peak),
            "resnet_params": train.n_params,
            "flops_per_step": train.flops_per_step,
            "step_ms": dt / steps * 1e3, "losses": losses,
            "launches_per_step": launches,
            "running_stats_finite": all(bool(torch.isfinite(b).all())
                                        for b in stats),
            "stem_mean_absmax": (None if stem is None else
                                 stem._mean.abs().max().item()),
            "seconds": {"setup": setup, "warmup": warmup, "steps": dt},
            **device_report(device)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--model", default=None,
                    help="a model of vision/models (default: bench.py's "
                         "ResNet configuration)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = (bench_config(device) if args.model is None
           else zoo_config(args.model, device))
    print(json.dumps(run_one(cfg, args.steps, device)))


if __name__ == "__main__":
    main()

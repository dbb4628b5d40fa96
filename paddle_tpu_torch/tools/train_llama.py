"""The Llama pretraining step: the counterpart of bench.py's `_llama_ladder`
(:53) and `_run_one` (:103).

    python3 -m paddle_tpu_torch.tools.train_llama [--config llama_1.3b]
        [--steps 8] [--device cuda]

Builds the config with random weights from seed(0), stacks its layers
(models.scanned), and trains it with AdamW at lr 3e-4 on
ids = RandomState(0).randint(0, vocab, (batch, seq)) with labels = ids:
one warm-up step, then `steps` timed steps. Prints one JSON line with the
result of `run_one`. Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import optimizer
from ..framework import resolve_device, seed
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..models.scanned import build_scanned_llama
from ..ops import flash_attention as fa

__all__ = ["llama_ladder", "loss_chunk_mb_for", "TrainStep", "run_one",
           "peak_flops", "launch_counts"]

LR = 3e-4

# dense bf16 tensor-core peaks by device name (NVIDIA data sheets)
_PEAK_BF16 = (("h100 pcie", 756e12), ("h100", 989e12), ("h200", 989e12))


def llama_ladder():
    """bench.py's configs, biggest first: (name, config, batch, seq, steps,
    remat)."""
    gpt3_1p3b = dict(vocab_size=32000, hidden_size=2048,
                     intermediate_size=8192, num_hidden_layers=24,
                     num_attention_heads=16, max_position_embeddings=2048,
                     dtype="bfloat16")
    llama_780m = dict(vocab_size=32000, hidden_size=1536,
                      intermediate_size=6144, num_hidden_layers=16,
                      num_attention_heads=16, max_position_embeddings=2048,
                      dtype="bfloat16")
    llama_535m = dict(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5504, num_hidden_layers=8,
                      num_attention_heads=16, max_position_embeddings=2048,
                      dtype="bfloat16")
    return [
        ("llama_1.3b", LlamaConfig(**gpt3_1p3b), 8, 2048, 8, True),
        ("llama_1.3b_small_batch", LlamaConfig(**gpt3_1p3b), 4, 2048, 8,
         True),
        ("llama_780m", LlamaConfig(**llama_780m), 8, 2048, 8, True),
        ("llama_535m", LlamaConfig(**llama_535m), 4, 2048, 8, False),
    ]


def loss_chunk_mb_for(name):
    """bench.py's per-config threshold of the fused LM loss (MiB of f32
    logits)."""
    return 1100 if name == "llama_535m" else 256


def peak_flops(device):
    """The card's dense bf16 peak, by its name; None off CUDA or for a card
    not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    return next((v for k, v in _PEAK_BF16 if k in name), None)


def launch_counts():
    """Each flash kernel's launches since its counter was last reset."""
    return {"flash_fwd": fa.flash_fwd_launches,
            "flash_bwd_dq": fa.flash_bwd_dq_launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches}


class TrainStep:
    """The training step of `cfg` at (batch, seq) on `device`: the model
    built with random weights from seed(0) and stacked
    (`build_scanned_llama`), AdamW at lr 3e-4 over the stacked params, and
    ids = labels = RandomState(0).randint(0, vocab, (batch, seq)).
    `step(n)` runs step n (`forward`, the backward, `update`) in place and
    returns the loss as a device tensor, with no host sync."""

    def __init__(self, cfg, batch, seq, remat, remat_policy=None,
                 loss_chunk_mb=256, device=None):
        device = resolve_device(device)
        seed(0)
        model = LlamaForCausalLM(cfg, device)
        self.n_params = model.num_params()
        self.params, self.loss_fn = build_scanned_llama(
            model, remat=remat, remat_policy=remat_policy,
            loss_chunk_mb=loss_chunk_mb)
        self.opt = optimizer.AdamW(LR, parameters=model.parameters())
        self.state = self.opt.tree_init(self.params)
        # the tree holds its own copies: free the model's weights, as
        # bench.py does (the template layer's are substituted by name on
        # every call)
        for p in model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (batch, seq)), device=device)

    def forward(self):
        return self.loss_fn(self.params, self.ids, self.ids)

    def update(self, step):
        grads = {k: {n: t.grad for n, t in group.items()}
                 for k, group in self.params.items()}
        self.opt.tree_update(self.params, grads, self.state, LR, step)
        for group in self.params.values():
            for t in group.values():
                t.grad = None

    def step(self, n):
        loss = self.forward()
        loss.backward()
        self.update(n)
        return loss.detach()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one(cfg, batch, seq, steps, remat, remat_policy=None,
            loss_chunk_mb=256, device=None):
    """One config: one warm-up step, then `steps` timed steps. Returns
    bench.py's keys where they apply (tokens_per_s, n_params, loss,
    step_time_s, lm_loss_path) and the per-step losses (warm-up first), the
    MFU (bench.py's 6N + 12 L h s FLOPs per token over the card's peak;
    None without one), the peak device memory, each step's kernel
    launches, and the seconds of set-up, warm-up and the timed steps."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    train = TrainStep(cfg, batch, seq, remat, remat_policy, loss_chunk_mb,
                      device)
    _sync(device)
    t1 = time.perf_counter()
    losses = [train.step(1)]
    _sync(device)
    t2 = time.perf_counter()
    launches = []
    for i in range(steps):
        before = launch_counts()
        losses.append(train.step(2 + i))
        launches.append({k: v - before[k]
                         for k, v in launch_counts().items()})
    _sync(device)
    dt = time.perf_counter() - t2
    losses = [float(x) for x in losses]
    tokens_per_s = batch * seq * steps / dt
    fpt = 6.0 * train.n_params + 12.0 * cfg.num_hidden_layers \
        * cfg.hidden_size * seq
    peak = peak_flops(device)
    return {"tokens_per_s": tokens_per_s, "n_params": train.n_params,
            "loss": losses[-1], "losses": losses,
            "step_time_s": dt / steps,
            "lm_loss_path": train.loss_fn.lm_loss_path,
            "mfu": None if peak is None else tokens_per_s * fpt / peak,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            "launches_per_step": launches,
            "seconds": {"setup": t1 - t0, "warmup": t2 - t1, "steps": dt},
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def main():
    ladder = {row[0]: row for row in llama_ladder()}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="llama_1.3b", choices=sorted(ladder))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    name, cfg, batch, seq, steps, remat = ladder[args.config]
    out = run_one(cfg, batch, seq, args.steps or steps, remat,
                  loss_chunk_mb=loss_chunk_mb_for(name), device=args.device)
    print(json.dumps({"config": name, "batch": batch, "seq": seq, **out}))


if __name__ == "__main__":
    main()

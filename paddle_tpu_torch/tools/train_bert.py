"""The BERT-base pretraining step: the counterpart of bench.py's
`_bench_bert` (:290-339), with `_functional_train_setup` (:210) and
`_time_train` (:241).

    python3 -m paddle_tpu_torch.tools.train_bert [--steps 8] [--device cuda]
        [--optimizer adamw|paddlenlp]

On CUDA (the default) it trains bench.py's configuration: BERT-base
(12 layers, hidden 768, 12 heads of 64, vocab 30522) without dropout, the
parameters cast to bf16, batch 32, sequence 512. With `--device cpu` it
trains bench.py's CPU configuration (2 layers, hidden 64, batch 2,
sequence 64) in float32. Either way: weights from seed(0), AdamW at lr
1e-4, ids = RandomState(0).randint(0, vocab, (batch, seq)) and MLM labels
from the same RandomState (a random id at 15% of the positions, else
-100), one warm-up step, then `steps` timed steps. Prints one JSON line
with the result of `run_one`. `--optimizer paddlenlp` trains with
PaddleNLP's BERT recipe instead (`paddlenlp_adamw`): AdamW under a linear
warm-up into a polynomial decay, decay on every parameter but biases and
norms, and the gradients clipped to a global norm of 1.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import nn, optimizer
from ..framework import resolve_device, seed
from ..framework.dtypes import convert_dtype
from ..models.bert import BertConfig, BertForPretraining
from .train_llama import _sync, device_report, mfu, time_steps

__all__ = ["bench_config", "paddlenlp_adamw", "TrainStep", "run_one"]

LR = 1e-4
OPTIMIZERS = ("adamw", "paddlenlp")


def bench_config(device):
    """bench.py's configuration for `device` (:297-305): (config, batch,
    seq, steps, dtype)."""
    if torch.device(device).type == "cuda":
        return BertConfig(dropout=0.0), 32, 512, 8, "bfloat16"
    cfg = BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=128, dropout=0.0)
    return cfg, 2, 64, 2, "float32"


def paddlenlp_adamw(model, total_steps, warmup_steps=2):
    """PaddleNLP's BERT pretraining optimizer: AdamW at peak lr 1e-4 under
    LinearWarmup (from 0 over `warmup_steps`) into PolynomialDecay to 0
    at `total_steps`, weight decay 0.01 with apply_decay_param_fun
    excluding biases and norms, and ClipGradByGlobalNorm(1.0)."""
    decay = {n for n, _ in model.named_parameters()
             if not any(k in n for k in ("bias", "norm"))}
    sched = optimizer.lr.LinearWarmup(
        optimizer.lr.PolynomialDecay(LR, total_steps, end_lr=0.0),
        warmup_steps=warmup_steps, start_lr=0.0, end_lr=LR)
    return optimizer.AdamW(
        sched, parameters=model.parameters(), weight_decay=0.01,
        apply_decay_param_fun=lambda n: n in decay,
        grad_clip=nn.ClipGradByGlobalNorm(1.0))


class TrainStep:
    """BertForPretraining of `cfg` built in float32 from seed(0), its
    parameters cast to `dtype` (bench.py's `to_bf16`), AdamW at lr 1e-4
    (or with `optimizer="paddlenlp"`, `paddlenlp_adamw` over
    `total_steps`, its scheduler stepped after each update), and the ids
    and MLM labels of bench.py from RandomState(0). `step(n)` runs the
    forward, the backward and the update in place and returns the loss as
    a float32 device tensor, with no host sync; the optimizer counts the
    steps itself (the warm-up is step 1)."""

    def __init__(self, cfg, batch, seq, dtype="bfloat16", device=None,
                 optimizer_name="adamw", total_steps=9):
        device = resolve_device(device)
        if optimizer_name not in OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer_name!r}; pick one of "
                             f"{OPTIMIZERS}")
        seed(0)
        self.model = BertForPretraining(cfg, device=device)
        self.n_params = sum(t.numel()
                            for t in self.model.state_dict().values())
        self.model.to(convert_dtype(dtype))
        if optimizer_name == "paddlenlp":
            self.opt = paddlenlp_adamw(self.model, total_steps)
        else:
            self.opt = optimizer.AdamW(LR,
                                       parameters=self.model.parameters())
        rng = np.random.RandomState(0)
        ids = rng.randint(0, cfg.vocab_size, (batch, seq))
        labels = np.where(rng.rand(batch, seq) < 0.15,
                          rng.randint(0, cfg.vocab_size, (batch, seq)), -100)
        self.ids = torch.as_tensor(ids, device=device)
        self.labels = torch.as_tensor(labels, device=device)

    def step(self, n):
        loss = self.model(self.ids, masked_lm_labels=self.labels)[0].float()
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        if isinstance(self.opt._learning_rate, optimizer.lr.LRScheduler):
            self.opt._learning_rate.step()
        return loss.detach()


def run_one(cfg, batch, seq, steps, dtype="bfloat16", device=None,
            optimizer_name="adamw"):
    """One warm-up step, then `steps` timed steps, with the `optimizer_name`
    recipe of TrainStep (bench.py's AdamW by default). Returns bench.py's
    keys
    (bert_tokens_per_s, bert_params, bert_loss, bert_batch, bert_seq,
    bert_base_mfu: 6N + 12 L h s FLOPs a token over the card's peak, None
    without one) and the step time in ms, the per-step losses (warm-up
    first),
    each timed step's kernel launches, the peak device memory and the
    seconds of set-up, warm-up and the timed steps."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    train = TrainStep(cfg, batch, seq, dtype, device, optimizer_name,
                      steps + 1)
    _sync(device)
    setup = time.perf_counter() - t0
    losses, launches, warmup, dt = time_steps(train.step, steps, device)
    tokens_per_s = batch * seq * steps / dt
    return {"bert_tokens_per_s": tokens_per_s, "bert_params": train.n_params,
            "bert_loss": losses[-1], "bert_batch": batch, "bert_seq": seq,
            "bert_base_mfu": mfu(train.n_params, cfg, seq, tokens_per_s,
                                 device),
            "step_ms": dt / steps * 1e3, "losses": losses,
            "launches_per_step": launches,
            "seconds": {"setup": setup, "warmup": warmup, "steps": dt},
            **device_report(device)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg, batch, seq, steps, dtype = bench_config(device)
    print(json.dumps(run_one(cfg, batch, seq, args.steps or steps, dtype,
                             device, args.optimizer)))


if __name__ == "__main__":
    main()

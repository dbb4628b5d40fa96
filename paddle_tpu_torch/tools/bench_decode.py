"""Serving decode, bf16 and weight-only int8: the counterpart of bench.py's
`_bench_decode` (:342-415), its bf16 and int8 legs.

    python3 -m paddle_tpu_torch.tools.bench_decode [--device cuda]

On CUDA (the default) it serves bench.py's configuration: a Llama of vocab
32000, hidden 2048, FFN 5504, 8 layers, 16 heads, in bf16, batch 8, prompt
128, 128 new tokens. With `--device cpu` it serves bench.py's CPU
configuration: vocab 512, hidden 128, FFN 256, 2 layers, 4 heads, in
float32, batch 2, prompt 16, 8 new tokens. Weights from seed(0), prompts
RandomState(0).randint(0, vocab, (batch, prompt)), greedy. Prints one JSON
line with the result of `run_one`.

bench.py's arithmetic: each leg calls `generate` once with
max_new_tokens=1 (the prefill) and once with all new tokens, as warm-ups,
then times 3 of each, each call ending in a synchronize;
decode_prefill_ms is the prefill-only call, the per-token time is
(full - prefill) / (new - 1) and tokens/s is batch / per-token. The int8
leg (`generation.WeightOnlyGenerator`, one snapshot shared by a 1-token
and a full-length generator) takes its own prefill baseline, and
decode_int8_weight_mb is its `quantized_bytes() / 2**20`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import generation
from ..framework import resolve_device, seed
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..ops import flash_attention as fa
from .train_llama import _sync, device_report

__all__ = ["bench_config", "build", "run_one", "time_leg"]

REPEATS = 3


def bench_config(device):
    """(LlamaConfig, batch, prompt, new tokens) of bench.py for `device`
    (:355-364)."""
    if torch.device(device).type == "cuda":
        return (LlamaConfig(vocab_size=32000, hidden_size=2048,
                            intermediate_size=5504, num_hidden_layers=8,
                            num_attention_heads=16,
                            max_position_embeddings=2048, dtype="bfloat16"),
                8, 128, 128)
    return (LlamaConfig(vocab_size=512, hidden_size=128,
                        intermediate_size=256, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=256),
            2, 16, 8)


def build(device=None):
    """bench.py's model, random weights from seed(0), and its prompts from
    RandomState(0) on `device`: (model, ids, new tokens)."""
    device = resolve_device(device)
    cfg, batch, prompt, new = bench_config(device)
    seed(0)
    model = LlamaForCausalLM(cfg, device=device)
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, prompt)),
                          device=device)
    return model, ids, new


def _timed(fn, device):
    """Seconds of one call of `fn`, ended by a synchronize, and its ids."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def time_leg(prefill, full, new, device):
    """bench.py's timing of one leg: a warm-up of each call, then REPEATS
    timed calls of each. Returns (mean prefill seconds, mean full seconds,
    the per-token seconds, the last full call's ids, K1 launches per
    prefill call and per full call, the leg's peak memory in bytes or
    None off CUDA)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _timed(prefill, device)
    _timed(full, device)
    k1 = []
    secs = []
    for fn in (prefill, full):
        before = fa.flash_fwd_launches
        ts = []
        for _ in range(REPEATS):
            t, ids = _timed(fn, device)
            ts.append(t)
        k1.append((fa.flash_fwd_launches - before) / REPEATS)
        secs.append(sum(ts) / REPEATS)
    per_tok = max(secs[1] - secs[0], 1e-9) / (new - 1)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return secs[0], secs[1], per_tok, ids, k1, peak


def run_one(device=None):
    """bench.py's decode legs on `device`. Returns bench.py's keys
    (decode_batch, decode_prompt, decode_new_tokens, decode_params,
    decode_prefill_ms, decode_per_token_ms, decode_tokens_per_s,
    decode_int8_per_token_ms, decode_int8_tokens_per_s,
    decode_int8_weight_mb, rounded as bench.py rounds them), then, per leg,
    the unrounded seconds, K1 launches per call, peak memory and the
    greedy ids of the last full call (`ids`, `int8_ids`), the model's
    weight bytes in its own dtype, and the device."""
    device = resolve_device(device)
    model, ids, new = build(device)
    batch, prompt = ids.shape
    out = {"decode_batch": batch, "decode_prompt": prompt,
           "decode_new_tokens": new,
           "decode_params": sum(p.numel() for p in model.parameters())}

    pre, full, per_tok, bf16_ids, k1, peak = time_leg(
        lambda: generation.generate(model, ids, max_new_tokens=1),
        lambda: generation.generate(model, ids, max_new_tokens=new),
        new, device)
    out["decode_prefill_ms"] = round(pre * 1e3, 2)
    out["decode_per_token_ms"] = round(per_tok * 1e3, 3)
    out["decode_tokens_per_s"] = round(batch / per_tok, 1)

    wog1 = generation.WeightOnlyGenerator(model, max_new_tokens=1)
    wog = generation.WeightOnlyGenerator(model, max_new_tokens=new,
                                         share_weights_from=wog1)
    q_pre, q_full, q_per_tok, int8_ids, q_k1, q_peak = time_leg(
        lambda: wog1.generate(ids), lambda: wog.generate(ids), new, device)
    out["decode_int8_per_token_ms"] = round(q_per_tok * 1e3, 3)
    out["decode_int8_tokens_per_s"] = round(batch / q_per_tok, 1)
    out["decode_int8_weight_mb"] = round(wog.quantized_bytes() / 2**20, 1)

    out.update({
        "seconds": {"prefill": pre, "full": full, "per_token": per_tok,
                    "int8_prefill": q_pre, "int8_full": q_full,
                    "int8_per_token": q_per_tok},
        "k1_launches_per_call": {"prefill": k1[0], "full": k1[1],
                                 "int8_prefill": q_k1[0],
                                 "int8_full": q_k1[1]},
        "peak_memory_bytes": {"bf16": peak, "int8": q_peak},
        "quantized_bytes": wog.quantized_bytes(),
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in model.parameters()),
        "ids": bf16_ids, "int8_ids": int8_ids,
        "device": device_report(device)["device"]})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    r = run_one(args.device)
    r["ids"] = r["ids"].tolist()
    r["int8_ids"] = r["int8_ids"].tolist()
    print(json.dumps(r))


if __name__ == "__main__":
    main()

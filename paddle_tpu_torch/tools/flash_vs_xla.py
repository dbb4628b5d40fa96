"""Time the flash kernels against the dense torch path on the card, the
measurements the attention ledger is baked from. reference:
tools/flash_vs_xla.py.

    python3 -m paddle_tpu_torch.tools.flash_vs_xla [--out PATH] [--reps 20]
        [--e2e-steps 3] [--no-e2e]

At each shape (bf16; the reference's four causal A/B shapes, the port's
two causal Llama main-path shapes and BERT-base's non-causal training
attention) it times, as medians of `reps` single calls on
CUDA events after two warm-up calls:
- the forward: `flash_attention_bshd` (K1) against the dense
  `scaled_dot_product_attention` math;
- forward + backward against a fixed dO: flash forward with K3/K4
  ('pallas'), flash forward with the dense rematerialised backward
  ('hybrid', FLAGS_flash_attention_bwd=xla), and dense autograd ('dense');
- the fused RMSNorm epilogue: `flash_attention_rms_epilogue_bshd` (K2)
  against K1 followed by the same epilogue in torch.
Every shape first checks flash against dense (and K2 against K1 plus the
torch epilogue) and records the largest difference.

Unless --no-e2e, it then runs the end-to-end A/B of the training step
(`tools/train_llama.run_one`, llama_1.3b at b8 s2048, one warm-up and
`--e2e-steps` timed steps) with the flash forward and each backward mode.

Writes one JSON file (default ./flash_vs_xla.json), which
`paddle_tpu_torch/tools/bake_attention_ledger.py` turns into the ledger.
Needs a CUDA device: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import torch

from ..framework import flags as _flags
from ..incubate.nn.functional import _rms_epilogue
from ..nn.functional.attention import _dense_attention, _expand_kv
from ..ops.attention_router import median_ms
from ..ops.flash_attention import (flash_attention_bshd,
                                   flash_attention_rms_epilogue_bshd)
from . import train_llama

# (seq, batch, heads, head_dim, causal)
SHAPES = [
    # the reference's A/B shapes (tools/flash_vs_xla.py:93)
    (1024, 8, 16, 128, True), (2048, 4, 8, 128, True),
    (4096, 1, 8, 128, True), (2048, 4, 8, 96, True),
    (512, 4, 32, 128, True),     # llama_7b serving prefill (chip_smoke.py)
    (2048, 8, 16, 128, True),    # llama_1.3b training attention
    (512, 32, 12, 64, False),    # BERT-base pretraining (bench.py:299)
]
EPS = 1e-6
# the end-to-end A/B: bench.py's top rung
E2E_CONFIG = "llama_1.3b"


def dense(q, k, v, causal=True):
    kx, vx = _expand_kv(k, v, q.shape[2])
    return _dense_attention(q, kx, vx, causal=causal)


def torch_epilogue(att, res, w):
    """incubate's unfused epilogue, after K1 here."""
    return _rms_epilogue(att, res, w, EPS)


def fwd_bwd(attn, q, k, v, g):
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = attn(*leaves)
    return torch.autograd.grad(out, leaves, g)


def measure_shape(seq, b, h, d, causal, reps):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v, g, res = (rand(b, seq, h, d) for _ in range(5))
    w = torch.randn(d, generator=gen, device="cuda")
    flash = lambda q_, k_, v_: flash_attention_bshd(q_, k_, v_,  # noqa: E731
                                                    causal=causal)
    plain = lambda q_, k_, v_: dense(q_, k_, v_, causal)  # noqa: E731
    with torch.no_grad():
        err = (flash(q, k, v).float() - plain(q, k, v).float()).abs().max()
        fused = flash_attention_rms_epilogue_bshd(q, k, v, res, w,
                                                  causal=causal, eps=EPS)
        unfused = torch_epilogue(flash(q, k, v), res, w)
        epi_err = (fused.float() - unfused.float()).abs().max()
        flash_fwd = median_ms(lambda: flash(q, k, v), reps, 2)
        dense_fwd = median_ms(lambda: plain(q, k, v), reps, 2)
        fused_ms = median_ms(lambda: flash_attention_rms_epilogue_bshd(
            q, k, v, res, w, causal=causal, eps=EPS), reps, 2)
        unfused_ms = median_ms(lambda: torch_epilogue(flash(q, k, v), res,
                                                      w), reps, 2)
    fb = {}
    for name, attn, mode in (("pallas", flash, "pallas"),
                             ("hybrid", flash, "xla"),
                             ("dense", plain, "pallas")):
        _flags.set_flags({"FLAGS_flash_attention_bwd": mode})
        try:
            fb[name] = median_ms(lambda: fwd_bwd(attn, q, k, v, g),
                                 reps, 2)
        finally:
            _flags.set_flags({"FLAGS_flash_attention_bwd": "auto"})
    return {"seq": seq, "batch": b, "heads": h, "head_dim": d,
            "causal": causal, "max_abs_err": err.item(),
            "epilogue_max_abs_err": epi_err.item(),
            "flash_fwd_ms": flash_fwd, "dense_fwd_ms": dense_fwd,
            "fwdbwd_ms_pallas": fb["pallas"],
            "fwdbwd_ms_hybrid": fb["hybrid"],
            "fwdbwd_ms_dense": fb["dense"],
            "fused_epilogue_ms": fused_ms,
            "unfused_epilogue_ms": unfused_ms}


def end_to_end(steps):
    """The training step with the flash forward and each backward mode."""
    ladder = {row[0]: row for row in train_llama.llama_ladder()}
    name, cfg, batch, seq, _, remat = ladder[E2E_CONFIG]
    rows = []
    for bwd in ("pallas", "xla"):
        gc.collect()
        torch.cuda.empty_cache()
        _flags.set_flags({"FLAGS_flash_attention_backend": "pallas",
                          "FLAGS_flash_attention_bwd": bwd})
        try:
            r = train_llama.run_one(
                cfg, batch, seq, steps, remat,
                loss_chunk_mb=train_llama.loss_chunk_mb_for(name),
                device="cuda")
        finally:
            _flags.set_flags({"FLAGS_flash_attention_backend": "auto",
                              "FLAGS_flash_attention_bwd": "auto"})
        rows.append({"config": name, "batch": batch, "seq": seq,
                     "heads": cfg.num_attention_heads,
                     "head_dim": cfg.hidden_size // cfg.num_attention_heads,
                     "fwd": "pallas", "bwd": bwd, "steps": steps,
                     "step_time_s": r["step_time_s"], "mfu": r["mfu"],
                     "tokens_per_s": r["tokens_per_s"],
                     "peak_memory_bytes": r["peak_memory_bytes"],
                     "losses": r["losses"],
                     "launches_per_step": r["launches_per_step"][-1]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="flash_vs_xla.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--e2e-steps", type=int, default=3)
    ap.add_argument("--no-e2e", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_vs_xla: no CUDA device; the timings need the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print("nvidia-smi:", smi, flush=True)
    rows = []
    for shape in SHAPES:
        rows.append(measure_shape(*shape, args.reps))
        print(json.dumps(rows[-1]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    doc = {"device_kind": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "dtype": "bfloat16",
           "reps": args.reps, "rows": rows,
           "end_to_end": [] if args.no_e2e else end_to_end(args.e2e_steps)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero if it fails:
  1. device: the card's name and power limit (nvidia-smi); TF32 is turned
     off for float32 matrix products.
  2. build: the CUDA kernels from paddle_tpu_torch/csrc, timed.
  3. K1: the flash-attention forward kernel against its plain torch version
     on the card in bf16 at the reference's test cases, GQA, d96 and the
     slice's prefill shape, with times (kernel, plain version, and
     torch's scaled_dot_product_attention as a yardstick only) and the
     least time the card could take.
  4. slice: llama_7b in bf16 at full width and depth, random weights from
     seed(0), serving 4 prompts of 512 tokens for 32 new tokens, greedy
     twice and sampled twice (each pair must agree), plus a prefill-only
     run for timing. The K1 launch count must rise by the number of layers
     per generate call. A tiny model on the card is held against the same
     weights in float32 on the CPU.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
# and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# K1 against its plain version in bf16: out within one or two bf16
# roundings (P is rounded to bf16 before P V at a different place in each:
# unnormalized in the kernel, normalized in the plain version), lse from f32
# scores summed in another order
OUT_ATOL = OUT_RTOL = 2e-2
LSE_ATOL = 1e-3
# tiny llama in bf16 on the card against the same weights in f32 on the CPU
TINY_LOGITS_ATOL = 0.1

PREFILL = dict(b=4, h=32, kvh=32, sq=512, sk=512, d=128, causal=True)
K1_CASES = (
    # the reference's CASES (tests/test_flash_attention.py:41), b2 h4
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128)
     for sq, sk, c in [(256, 256, False), (256, 256, True),
                       (200, 200, True), (384, 384, True),
                       (520, 520, True), (128, 320, True),
                       (100, 260, False)]]
    + [dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True),   # GQA
       dict(b=2, h=8, kvh=8, sq=256, sk=256, d=96, causal=True),     # pad
       PREFILL])


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=25, warmup=3):
    """Median of `reps` single-call times on CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_bound_ms(b, h, kvh, sq, sk, d, causal, itemsize=2):
    """Least time for the work of one K1 call: bytes (q, k, v read once,
    out and lse written once) over HBM rate against the products' FLOPs
    over the bf16 peak, counting only the (row, key) pairs the causal mask
    admits."""
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    if causal:
        rows = np.arange(sq)
        pairs = int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())
    else:
        pairs = sq * sk
    flops = 4 * d * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_attention(q, k, v, causal):
    """torch's own fused attention on (b, h, s, d), the yardstick: never
    called by the port."""
    sq, sk = q.shape[2], k.shape[2]
    if not causal:
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)
    if sq == sk:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    from torch.nn.attention.bias import causal_lower_right
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=causal_lower_right(sq, sk))


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log("nvidia-smi:", smi.stdout.strip().splitlines()[0])
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for float32 matmul and cuDNN")


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    log(f"build: kernel library ready in {time.perf_counter() - t0:.2f} s")
    for entry in _build.build_log:
        for line in entry.splitlines():
            if "registers" in line or "spill" in line:
                log("  nvcc:", line.strip())


def phase_k1():
    """K1 vs its plain version at every case; returns the prefill case's
    record."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    record = None
    for case in K1_CASES:
        b, h, kvh, sq, sk, d, causal = (case[x] for x in
                                        ("b", "h", "kvh", "sq", "sk", "d",
                                         "causal"))

        def rand(s, heads):
            return torch.randn(b, s, heads, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v = rand(sq, h), rand(sk, kvh), rand(sk, kvh)
        scale = 1.0 / d ** 0.5
        dp = 64 if d <= 64 else 128

        def bhsd(x, pad):
            x = torch.nn.functional.pad(x, (0, pad)) if pad else x
            return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]) \
                .contiguous()
        qk, kk, vk = (bhsd(x, dp - d) for x in (q, k, v))     # kernel input
        qp, kp, vp = (bhsd(x, 0) for x in (q, k, v))          # plain input
        rep = h // kvh
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa._flash_fwd_bhsd_plain(qp, kp, vp, causal,
                                                        scale, rep)
            out = out[..., :d].float()
            err_out = (out - ref_out.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            ok = (torch.allclose(out, ref_out.float(), atol=OUT_ATOL,
                                 rtol=OUT_RTOL)
                  and err_lse <= LSE_ATOL)
            ms = time_ms(lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal,
                                                    scale, rep))
            plain_ms = time_ms(lambda: fa._flash_fwd_bhsd_plain(
                qp, kp, vp, causal, scale, rep))
            ql = q.transpose(1, 2).contiguous()
            kl = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            vl = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            library_ms = time_ms(lambda: library_attention(ql, kl, vl,
                                                           causal))
        bound, bound_by = k1_bound_ms(b, h, kvh, sq, sk, d, causal)
        log(f"K1 b{b} h{h}/kv{kvh} sq{sq} sk{sk} d{d} causal={causal}: "
            f"max|out err| {err_out:.3e} max|lse err| {err_lse:.3e} "
            f"(tol out {OUT_ATOL}+{OUT_RTOL}*|ref|, lse {LSE_ATOL}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"sdpa {library_ms:.4f} ms bound {bound * 1e3:.2f} us "
            f"({bound_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K1 disagrees with its plain version at "
                     f"{case}")
        if case is PREFILL:
            record = dict(max_abs_err=max(err_out, err_lse), ms=ms,
                          plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by, library_ms=library_ms)
    return record


def phase_tiny_reference():
    """A tiny llama in bf16 on the card against the same weights in f32 on
    the CPU (plain attention there)."""
    pt.seed(1)
    gpu = pt.models.llama_tiny(dtype="bfloat16", device="cuda")
    cpu = pt.models.llama_tiny(device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in gpu.state_dict().items()})
    ids = np.random.RandomState(1).randint(0, 512, (2, 64))
    with torch.inference_mode():
        got = gpu(torch.as_tensor(ids, device="cuda")).float().cpu()
        want = cpu(torch.as_tensor(ids))
    err = (got - want).abs().max().item()
    log(f"tiny llama bf16 on card vs f32 on CPU: max|logit err| {err:.3e} "
        f"(tol {TINY_LOGITS_ATOL}, max|logit| {want.abs().max().item():.3f})")
    if not err <= TINY_LOGITS_ATOL:
        sys.exit("chip_smoke: tiny llama on the card disagrees with the CPU")


def phase_slice():
    """llama_7b serving 4 x 512-token prompts; returns K1's launches over
    the main path."""
    pt.seed(0)
    t0 = time.perf_counter()
    model = pt.models.llama_7b(dtype="bfloat16", device="cuda")
    model.eval()
    torch.cuda.synchronize()
    cfg = model.config
    log(f"llama_7b: {model.num_params()} params, {cfg.num_hidden_layers} "
        f"layers, hidden {cfg.hidden_size}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    b, s, new = 4, 512, 32
    ids = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s)),
        device="cuda")
    sampled = dict(do_sample=True, temperature=0.8, top_p=0.9, seed=7)
    runs = [("greedy", new, {}), ("greedy", new, {}),
            ("sampled", new, sampled), ("sampled", new, sampled),
            ("prefill-only", 1, {})]
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_launches = 0                  # the main path starts here
    outs, secs = [], []
    for name, n, kw in runs:
        before = fa.flash_fwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generation.generate(model, ids, max_new_tokens=n, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        launched = fa.flash_fwd_launches - before
        log(f"generate {name}: {tuple(out.shape)} in {secs[-1]:.3f} s, "
            f"K1 launches {launched}")
        if launched != cfg.num_hidden_layers:
            sys.exit(f"chip_smoke: {launched} K1 launches in one generate, "
                     f"expected {cfg.num_hidden_layers}")
        if out.shape != (b, s + n) or not torch.equal(out[:, :s], ids):
            sys.exit("chip_smoke: generate returned a wrong shape or prompt")
        if out.min().item() < 0 or out.max().item() >= cfg.vocab_size:
            sys.exit("chip_smoke: a token id is out of the vocabulary")
    launches = fa.flash_fwd_launches           # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(outs[0], outs[1]):
        sys.exit("chip_smoke: two greedy runs disagree")
    if not torch.equal(outs[2], outs[3]):
        sys.exit("chip_smoke: two sampled runs with one seed disagree")
    if not torch.equal(outs[4][:, s], outs[0][:, s]):
        sys.exit("chip_smoke: prefill-only first token differs from greedy")
    with torch.inference_mode():
        hidden = model.llama(ids)
    if not torch.isfinite(hidden).all():
        sys.exit("chip_smoke: non-finite prefill hidden state")
    prefill_ms = secs[4] * 1e3
    decode_ms = (secs[1] - secs[4]) / (new - 1) * 1e3
    log(f"slice: prefill {prefill_ms:.1f} ms (b{b} s{s}), decode "
        f"{decode_ms:.2f} ms/token step, greedy {b * new / secs[1]:.1f} "
        f"tokens/s ({b}x{new} in {secs[1]:.3f} s), sampled "
        f"{b * new / secs[3]:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB, greedy tokens differ from sampled in "
        f"{(outs[0][:, s:] != outs[2][:, s:]).float().mean().item():.2%}")
    return launches


def main():
    phase_device()
    phase_build()
    k1 = phase_k1()
    phase_tiny_reference()
    launches = phase_slice()
    kernels = [dict(name="flash_fwd", route="cuda",
                    source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                    replaces="paddle_tpu/ops/pallas/flash_attention.py:116",
                    launches=launches, **k1)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

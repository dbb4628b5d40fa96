#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero if it fails:
  1. device: the card's name and power limit (nvidia-smi); TF32 is turned
     off for float32 matrix products.
  2. build: the CUDA kernels from paddle_tpu_torch/csrc, timed; fails if
     ptxas reports a spill in any instantiation of the forward or backward
     kernels or ignores a setmaxnreg (warning C7508).
  3. K1: the flash-attention forward kernel against its plain torch version
     on the card in bf16 at the reference's test cases, GQA, d96, the
     edges of the kernel's 128-row block and 128-key ring tiles (sq = sk
     64, 127, 129; sq 1 over sk 300; sq 130 over sk 1000; causal sq 300
     over sk 100, whose first 200 rows admit no key: finite everywhere,
     compared where a row has keys; GQA 8:1 at d64), the serving slice's prefill shape and the training slice's
     attention shape (also in fp16), with times (kernel, plain version,
     and torch's scaled_dot_product_attention as a yardstick only) and the
     least time the card could take. Kernel and SDPA times are given
     twice: the median single call, host work included, and the device
     time per call of 20 back-to-back calls replayed from one CUDA graph
     (no host work between them); the record keeps the latter.
  4. K2: the fused RMSNorm epilogue (K1's kernel with the
     rmsnorm(attn + residual) * gamma flush) against its plain torch
     version in bf16 (and fp16 at two cases): d64, d128, d96 padded
     (mean over the true d), GQA 4/2 and 32/8, ragged s200 and s520,
     sq != sk, K1's edge cases, the prefill and training shapes; its lse
     equal bit for bit to K1's; times as K1's against its bound, the plain
     version, and, as yardsticks only, K1 alone and K1 followed by the
     torch epilogue.
  5. K3/K4: the flash-attention backward kernels against the plain
     backward in bf16 at K1's cases, the edge cases included (and in fp16
     at the training shape and two more), dQ, dK and dV repeated bit for bit, and back-to-back
     times at the training shape with their rate and share of the bound
     (torch's own flash-attention backward as a yardstick only), beside the
     wrapper's delta = rowsum(dO * O) pass. In the causal sq 300 over sk
     100 case the rows of dO that admit no key are zero: such rows are
     undefined in the forward, and with dO zero they add nothing in either
     version.
  6. router: the shipped H100 ledger's decision, with its provenance, at
     the serving prefill shape and the training attention shape, and
     whether it marks the fused epilogue a winner there. The launch counts
     the later phases expect follow from these decisions.
  7. tiny models on the card against the same weights in float32 on the
     CPU: the logits, then the training step's loss, every gradient and
     one AdamW step.
  8. serving slice: llama_7b in bf16 at full width and depth, random
     weights from seed(0), serving 4 prompts of 512 tokens for 32 new
     tokens, greedy twice and sampled twice (each pair must agree), plus a
     prefill-only run for timing. The K1 launch count must rise by the
     number of layers per generate call where the router picks K1.
  9. fused epilogue: incubate's fused_attention_rms_epilogue at llama_7b's
     attention widths (b4 s512, 32 heads of 128) and at llama_1.3b's
     training attention shape (b8 s2048, 16 heads), bf16, residual and
     gamma from a seeded numpy draw: one K2 launch per call where the
     ledger marks the fusion a winner, the output against the unfused
     composition.
  10. training slice: llama_1.3b (bench.py's top rung) in bf16 at full
     width and depth, batch 8, sequence 2048, per-layer remat, chunked LM
     loss, AdamW: one warm-up step and 8 timed steps through
     paddle_tpu_torch.tools.train_llama.run_one. Every loss must be finite,
     the last below the first, and with the router's choice of the
     kernels each step must launch K1 twice per layer (forward and remat
     recompute) and K3 and K4 once per layer.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.models import build_scanned_llama
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention_router as ar
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import train_llama

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
# K2 against its plain version: the attention output before the epilogue
# differs as K1's does (above), and the epilogue multiplies it by
# rsqrt(mean(h^2)) * gamma, about |gamma| for h = attn + a unit-variance
# residual, and the kernel adds the residual to the f32 attention output
# while the unfused composition of phase 9 adds it to the bf16-rounded one:
# so |err| <= K2_ATOL * max|gamma| + K2_RTOL * |ref|
K2_ATOL = 3e-2
K2_RTOL = 2e-2
RMS_EPS = 1e-6
# K3/K4 against the plain backward in bf16 (or fp16), each gradient
# relative to its largest magnitude: both round P and dS to bf16 at the
# same points, but from f32 sums taken in another order, so a rounding may
# fall the other way; the gradients are rounded to bf16 (a relative step
# of 2^-8)
BWD_RTOL = 2e-2
# tiny llama in bf16 on the card against the same weights in f32 on the CPU
TINY_LOGITS_ATOL = 0.1
# the tiny training step, bf16 on the card against f32 on the CPU: every
# activation and gradient is rounded to bf16 at each op through two layers
# and back. Loss relative to its value; each gradient and moment relative
# to its largest magnitude; parameters after one AdamW step within 2 lr
# (the first update is at most lr in size, about lr * sign(grad), and the
# sign of a gradient near 0 may differ) plus the bf16 rounding of the
# updated parameter
TINY_LOSS_RTOL = 1e-2
TINY_GRAD_RTOL = 5e-2
TINY_LR = 1e-3

PREFILL = dict(b=4, h=32, kvh=32, sq=512, sk=512, d=128, causal=True)
# the training slice's attention: llama_1.3b at batch 8, sequence 2048
TRAIN_ATTN = dict(b=8, h=16, kvh=16, sq=2048, sk=2048, d=128, causal=True)
# the edges of the forward kernel's 128-row block and 128-key ring tiles
# (two slots at d128, three at d64): one tile, one row short of and one
# past a block, a single query row over three key tiles, two query blocks
# over eight key tiles, and three query blocks over one key tile whose first
# 200 rows admit no key (causal, sq > sk)
EDGES = [(64, 64, True), (127, 127, True), (129, 129, True), (1, 300, False),
         (130, 1000, True), (300, 100, True)]
FWD_EDGE_CASES = (
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128) for sq, sk, c in EDGES]
    + [dict(b=2, h=32, kvh=4, sq=256, sk=256, d=64, causal=True),    # GQA 8:1
       dict(TRAIN_ATTN, dtype=torch.float16)])
BASE_CASES = (
    # the reference's CASES (tests/test_flash_attention.py:41), b2 h4
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128)
     for sq, sk, c in [(256, 256, False), (256, 256, True),
                       (200, 200, True), (384, 384, True),
                       (520, 520, True), (128, 320, True),
                       (100, 260, False)]]
    + [dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True),   # GQA
       dict(b=2, h=8, kvh=8, sq=256, sk=256, d=96, causal=True),     # pad
       PREFILL, TRAIN_ATTN])
K1_CASES = BASE_CASES + FWD_EDGE_CASES
K2_CASES = (
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128)
     for sq, sk, c in [(256, 256, True), (200, 200, True), (520, 520, True),
                       (128, 320, True), (100, 260, False)]]
    + [dict(b=2, h=4, kvh=2, sq=256, sk=256, d=64, causal=True),     # GQA
       dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True),   # GQA
       dict(b=2, h=8, kvh=8, sq=256, sk=256, d=96, causal=True),     # pad
       dict(b=2, h=4, kvh=4, sq=200, sk=200, d=128, causal=True,
            dtype=torch.float16),
       PREFILL, TRAIN_ATTN]
    + FWD_EDGE_CASES)
# K3/K4 at K1's cases, and also in fp16 at a GQA case and a padded case
K34_CASES = BASE_CASES + FWD_EDGE_CASES + (
    [dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True,
          dtype=torch.float16),
     dict(b=2, h=4, kvh=4, sq=200, sk=200, d=64, causal=True,
          dtype=torch.float16)])


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=25, warmup=3):
    """Median of `reps` single-call times on CUDA events, after warm-up:
    each call's host work (tensor maps, ctypes, allocation) can show."""
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


def device_ms(fn, calls=20, warmup=3):
    """Device time of one call: `calls` back-to-back calls captured in one
    CUDA graph and replayed between one pair of CUDA events, so no host
    work (tensor-map encoding, ctypes, allocation) lies between them. A
    call that cannot be captured raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound_ms(nbytes, flops):
    """Least time for `nbytes` moved and `flops` done: the larger of bytes
    over the HBM rate and FLOPs over the bf16 peak, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(sq, sk, causal):
    """(row, key) pairs a head computes: those the causal mask admits."""
    if not causal:
        return sq * sk
    rows = np.arange(sq)
    return int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())


def k1_bound_ms(b, h, kvh, sq, sk, d, causal, itemsize=2, **_):
    """One K1 call: q, k, v read once, out and lse written once; two
    products (Q K^T, P V) of 2 d FLOP a pair."""
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    return bound_ms(nbytes, 2 * 2 * d * attn_pairs(sq, sk, causal) * b * h)


def k2_bound_ms(b, h, kvh, sq, sk, d, causal, itemsize=2, **_):
    """One K2 call: K1's bytes plus the residual read and gamma (f32) read
    once; K1's two products. The epilogue's f32 elementwise work (about 6
    operations an output element: 0.75 us at the prefill shape at the
    67 TFLOP/s f32 rate) is left out, as K1's bound leaves out the
    softmax."""
    nbytes = (itemsize * d * (3 * b * h * sq + 2 * b * kvh * sk)
              + 4 * b * h * sq + 4 * d)
    return bound_ms(nbytes, 2 * 2 * d * attn_pairs(sq, sk, causal) * b * h)


def bwd_flops(kernel, b, h, sq, sk, d, causal, **_):
    """FLOPs of one K3 call (three products: Q K^T, dO V^T, dS K) or one K4
    call (four: Q K^T, dO V^T, P^T dO, dS^T Q), 2 d a (row, key) pair
    each."""
    products = 3 if kernel == "dq" else 4
    return products * 2 * d * attn_pairs(sq, sk, causal) * b * h


def bwd_bound_ms(kernel, b, h, kvh, sq, sk, d, causal, itemsize=2):
    """One K3 call (dq written) or one K4 call (dk and dv written); each
    reads q, dO, k, v, lse and delta once."""
    nbytes = (itemsize * d * (2 * b * h * sq + 2 * b * kvh * sk)
              + 8 * b * h * sq)
    if kernel == "dq":
        nbytes += itemsize * d * b * h * sq
    else:
        nbytes += 2 * itemsize * d * b * kvh * sk
    return bound_ms(nbytes, bwd_flops(kernel, b, h, sq, sk, d, causal))


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


def library_attention_bwd(q, k, v, g, causal):
    """torch's own flash-attention backward on (b, h, s, d), dq, dk and dv
    in one call, the yardstick of K3 and K4 together: never called by the
    port. Returns a function that runs the backward alone."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        g, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed,
        offset)


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
    """Build the kernels; fail if ptxas spills in any instantiation of the
    forward or backward kernels or ignores a setmaxnreg (warning C7508)."""
    t0 = time.perf_counter()
    _build.library()
    log(f"build: kernel library ready in {time.perf_counter() - t0:.2f} s")
    faults = []
    for entry in _build.build_log:
        function = ""
        for line in entry.splitlines():
            if "C7508" in line or ("warning" in line
                                   and "setmaxnreg" in line):
                faults.append(line.strip())
            if "Compiling entry function" in line or \
                    "Function properties for" in line:
                function = line.split()[-1] if "properties" in line \
                    else line.split("'")[1]
            if "registers" in line or "spill" in line:
                log("  nvcc:", line.strip())
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            if re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernel", function) \
                    and any(spills):
                faults.append(f"{function}: {line.strip()}")
    if faults:
        sys.exit("chip_smoke: a flash kernel spills or loses its "
                 "setmaxnreg:\n" + "\n".join(faults))
    log("build: no spills and no C7508 in the forward and backward kernels")


def case_inputs(case, gen, with_grad=False):
    """Random (b, s, heads, d) q, k, v (and dO) for a case, in its dtype
    (bf16 by default), and each as (BH, S, D): padded to the kernels' head
    dim, and as it is for the plain versions."""
    b, h, kvh, sq, sk, d = (case[x] for x in ("b", "h", "kvh", "sq", "sk",
                                              "d"))

    def rand(s, heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    dtype = case.get("dtype", torch.bfloat16)
    xs = [rand(sq, h), rand(sk, kvh), rand(sk, kvh)]
    if with_grad:
        xs.append(rand(sq, h))
    pad = (64 if d <= 64 else 128) - d

    return (xs, [bhsd(x, pad) for x in xs], [bhsd(x, 0) for x in xs])


def bhsd(x, pad):
    """(b, s, heads, d) -> (b * heads, s, d + pad), zero-padded."""
    x = torch.nn.functional.pad(x, (0, pad)) if pad else x
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]) \
        .contiguous()


def live_rows(case):
    """(sq,) bool on the card: the query rows that admit at least one key.
    Under the bottom-right causal mask with sq > sk the first sq - sk rows
    admit none; their values are undefined and not compared."""
    rows = torch.arange(case["sq"], device="cuda")
    if not case["causal"]:
        return torch.ones_like(rows, dtype=torch.bool)
    return rows >= case["sq"] - case["sk"]


def case_name(case):
    dtype = str(case.get("dtype", torch.bfloat16)).replace("torch.", "")
    return (f"b{case['b']} h{case['h']}/kv{case['kvh']} sq{case['sq']} "
            f"sk{case['sk']} d{case['d']} causal={case['causal']} {dtype}")


def phase_k1():
    """K1 vs its plain version at every case; returns the records of the
    prefill and training shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = {}
    for case in K1_CASES:
        h, kvh, d, causal = case["h"], case["kvh"], case["d"], case["causal"]
        (q, k, v), (qk, kk, vk), (qp, kp, vp) = case_inputs(case, gen)
        scale = 1.0 / d ** 0.5
        rep = h // kvh
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa._flash_fwd_bhsd_plain(qp, kp, vp, causal,
                                                        scale, rep)
            out = out[..., :d].float()
            finite = bool(torch.isfinite(out).all() and
                          torch.isfinite(lse).all())
            live = live_rows(case)
            out, ref_out = out[:, live], ref_out[:, live].float()
            err_out = (out - ref_out).abs().max().item()
            err_lse = (lse[:, live] - ref_lse[:, live]).abs().max().item()
            ok = (finite and err_lse <= LSE_ATOL
                  and torch.allclose(out, ref_out, atol=OUT_ATOL,
                                     rtol=OUT_RTOL))
            del ref_out, ref_lse
            kernel = lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal, scale,
                                                rep)
            call_ms, ms = time_ms(kernel), device_ms(kernel)
            plain_ms = time_ms(lambda: fa._flash_fwd_bhsd_plain(
                qp, kp, vp, causal, scale, rep))
            ql = q.transpose(1, 2).contiguous()
            kl = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            vl = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            library = lambda: library_attention(ql, kl, vl, causal)
            library_call_ms, library_ms = time_ms(library), device_ms(library)
        bound, bound_by = k1_bound_ms(**case)
        log(f"K1 {case_name(case)}: "
            f"max|out err| {err_out:.3e} max|lse err| {err_lse:.3e} "
            f"(tol out {OUT_ATOL}+{OUT_RTOL}*|ref|, lse {LSE_ATOL}) "
            f"kernel {ms:.4f} ms back to back ({call_ms:.4f} single call) "
            f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms back to "
            f"back ({library_call_ms:.4f} single call) bound "
            f"{bound * 1e3:.2f} us ({bound_by}) finite: {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K1 disagrees with its plain version at "
                     f"{case}")
        for name, shape in (("prefill", PREFILL), ("train", TRAIN_ATTN)):
            if case is shape:
                records[name] = dict(
                    max_abs_err=max(err_out, err_lse), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                    library_ms=library_ms)
    return records


def epilogue_inputs(case, seed):
    """Residual (b, sq, h, d) in the case's dtype and gamma (d,) f32 on the
    card, from a seeded numpy draw."""
    rs = np.random.RandomState(seed)
    dtype = case.get("dtype", torch.bfloat16)
    res = torch.as_tensor(rs.randn(case["b"], case["sq"], case["h"],
                                   case["d"]).astype(np.float32),
                          device="cuda").to(dtype)
    w = torch.as_tensor(rs.randn(case["d"]).astype(np.float32),
                        device="cuda")
    return res, w


def torch_epilogue(att, res, w):
    """incubate's unfused epilogue: rmsnorm(att + res) * w over the last
    dim, in att's dtype."""
    return IF._rms_epilogue(att, res, w, RMS_EPS)


def phase_k2():
    """K2 vs its plain version at every case, its lse against K1's; returns
    the records of the prefill and training shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    records = {}
    for i, case in enumerate(K2_CASES):
        h, kvh, d, causal = case["h"], case["kvh"], case["d"], case["causal"]
        _, (qk, kk, vk), (qp, kp, vp) = case_inputs(case, gen)
        res, w = epilogue_inputs(case, 100 + i)
        dp = qk.shape[2]
        rk = bhsd(res, dp - d)
        rp = bhsd(res, 0)
        wk = torch.nn.functional.pad(w, (0, dp - d))
        scale = 1.0 / d ** 0.5
        rep = h // kvh
        kw = dict(residual=rk, rms_weight=wk, rms_eps=RMS_EPS, rms_d=d)
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep,
                                          **kw)
            _, k1_lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa._flash_fwd_bhsd_plain(
                qp, kp, vp, causal, scale, rep, rp, w, RMS_EPS, d)
            out = out[..., :d].float()
            finite = bool(torch.isfinite(out).all() and
                          torch.isfinite(lse).all())
            live = live_rows(case)
            out, ref_out = out[:, live], ref_out[:, live].float()
            gmax = w.abs().max().item()
            err_out = (out - ref_out).abs().max().item()
            err_lse = (lse[:, live] - ref_lse[:, live]).abs().max().item()
            ok = (finite and bool(((out - ref_out).abs() <= K2_ATOL * gmax
                                   + K2_RTOL * ref_out.abs()).all())
                  and err_lse <= LSE_ATOL and torch.equal(lse, k1_lse))
            del ref_out, ref_lse
            timed = case is PREFILL or case is TRAIN_ATTN
            if timed:
                kernel = lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal,
                                                    scale, rep, **kw)
                k1 = lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal, scale,
                                                rep)
                call_ms, ms = time_ms(kernel), device_ms(kernel)
                plain_ms = time_ms(lambda: fa._flash_fwd_bhsd_plain(
                    qp, kp, vp, causal, scale, rep, rp, w, RMS_EPS, d),
                    reps=5)
                k1_call_ms, k1_ms = time_ms(k1), device_ms(k1)
                unfused_ms = device_ms(lambda: torch_epilogue(k1()[0], rk,
                                                              wk))
        bound, bound_by = k2_bound_ms(**case)
        log(f"K2 {case_name(case)}: max|out err| {err_out:.3e} "
            f"(tol {K2_ATOL}*max|gamma| {gmax:.2f} + {K2_RTOL}*|ref|) "
            f"max|lse err| {err_lse:.3e} (tol {LSE_ATOL}), lse equal to "
            f"K1's: {torch.equal(lse, k1_lse)}, finite: {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K2 disagrees with its plain version at "
                     f"{case}")
        if not timed:
            continue
        log(f"  K2 kernel {ms:.4f} ms back to back ({call_ms:.4f} single "
            f"call), bound {bound:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.4f} ms; yardsticks back to back: K1 alone "
            f"{k1_ms:.4f} ms ({k1_call_ms:.4f} single call; K2/K1 "
            f"{ms / k1_ms:.3f}), K1 + torch epilogue {unfused_ms:.4f} ms")
        records["prefill" if case is PREFILL else "train"] = dict(
            max_abs_err=max(err_out, err_lse), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=None)
    return records


def phase_k34():
    """K3 and K4 vs the plain backward at every case, on the kernel
    forward's out and lse; dQ, dK and dV repeated bit for bit; times at the
    training shape. Returns the records of K3 and K4 there."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    records = {}
    for case in K34_CASES:
        h, kvh, d, causal = case["h"], case["kvh"], case["d"], case["causal"]
        xs, (qk, kk, vk, gk), (qp, kp, vp, gp) = case_inputs(case, gen, True)
        # rows that admit no key (causal sq > sk) are undefined in the
        # forward; with dO zero there they add nothing in either version
        dead = ~live_rows(case)
        gk[:, dead] = 0
        gp[:, dead] = 0
        scale = 1.0 / d ** 0.5
        rep = h // kvh
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            got = fa._flash_bwd_bhsd(qk, kk, vk, out, lse, gk, causal, scale,
                                     rep)
            again = fa._flash_bwd_bhsd(qk, kk, vk, out, lse, gk, causal,
                                       scale, rep)
            torch.cuda.synchronize()
            ref = fa._flash_bwd_bhsd_plain(
                qp, kp, vp, out[..., :d].contiguous(), lse, gp, causal, scale,
                rep)
            abs_errs, errs = [], []
            for x, r in zip(got, ref):
                r = r.float()
                abs_errs.append((x[..., :d].float() - r).abs().max().item())
                errs.append(abs_errs[-1] / r.abs().max().item())
            del ref
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = finite and all(e <= BWD_RTOL for e in errs) and repeat
        log(f"K3/K4 {case_name(case)}: max|err|/max|ref| dq {errs[0]:.3e} "
            f"dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {BWD_RTOL}), finite: "
            f"{finite}, dq/dk/dv repeat bitwise: {repeat} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K3/K4 disagree with the plain backward "
                     f"or do not repeat at {case}")
        if case is not TRAIN_ATTN:
            continue
        with torch.inference_mode():
            # the wrapper's delta pass, as _flash_bwd_bhsd takes it
            delta_fn = lambda: (gk.float() * out.float()).sum(-1)
            delta = delta_fn()
            args = (qk, kk, vk, gk, lse, delta, causal, scale, rep)
            dq_ms = device_ms(lambda: fa._flash_bwd_dq_cuda(*args))
            dkv_ms = device_ms(lambda: fa._flash_bwd_dkv_cuda(*args))
            delta_ms = device_ms(delta_fn)
            plain_ms = time_ms(lambda: fa._flash_bwd_bhsd_plain(
                qp, kp, vp, out, lse, gp, causal, scale, rep), reps=5)
            lib = library_attention_bwd(
                *(x.transpose(1, 2).contiguous() for x in xs[:3]),
                xs[3].transpose(1, 2).contiguous(), causal)
            library_ms = device_ms(lib)
        for name, ms, err in (("dq", dq_ms, abs_errs[0]),
                              ("dkv", dkv_ms, max(abs_errs[1:]))):
            bound, bound_by = bwd_bound_ms(name, **case)
            records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=bound_by,
                                 library_ms=library_ms)
            tflops = bwd_flops(name, **case) / (ms * 1e-3) / 1e12
            log(f"  K{3 if name == 'dq' else 4} ({name}): kernel {ms:.4f} ms "
                f"back to back, {tflops:.1f} TFLOP/s, bound {bound:.4f} ms "
                f"({bound_by}), {bound / ms:.1%} of the bound")
        log(f"  delta = rowsum(dO * O) in the wrapper {delta_ms:.4f} ms; "
            f"plain backward (dq, dk, dv) {plain_ms:.4f} ms; torch flash "
            f"backward (dq, dk, dv) {library_ms:.4f} ms back to back against "
            f"K3+K4 {dq_ms + dkv_ms:.4f} ms (with delta "
            f"{dq_ms + dkv_ms + delta_ms:.4f} ms)")
    return records


def phase_router():
    """The ledger's decisions at the two main-path attention shapes, with
    their provenance. Returns {"prefill" | "train": (Decision, whether the
    fused epilogue wins)}."""
    led = ar.load_ledger()
    if led is None:
        sys.exit("chip_smoke: the shipped attention ledger does not load")
    log(f"router: ledger v{led.get('version')} r{led.get('round')} of "
        f"{led.get('device_kind')} ({led.get('nvidia_smi')}), "
        f"{len(led.get('entries', []))} entries, "
        f"{len(led.get('end_to_end', []))} end-to-end")
    decisions = {}
    for name, case in (("prefill", PREFILL), ("train", TRAIN_ATTN)):
        bh = case["b"] * case["h"]
        key = (bh, case["sq"], case["sk"], case["d"], torch.bfloat16,
               case["causal"])
        dec = ar.route(*key)
        wins = ar.epilogue_fusion_wins(*key)
        log(f"router {name} (bh {bh}, s{case['sq']}, d{case['d']}, bf16, "
            f"causal): {dec}; fused epilogue wins: {wins}")
        if dec.source not in ("ledger", "ledger-e2e"):
            sys.exit(f"chip_smoke: the ledger has no row for the {name} "
                     f"shape on {torch.cuda.get_device_name(0)}")
        decisions[name] = (dec, wins)
    return decisions


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


def phase_slice(decision):
    """llama_7b serving 4 x 512-token prompts; returns K1's launches over
    the main path. `decision` is the router's at the prefill shape: each
    generate launches K1 once per layer if its forward is the kernel, else
    never."""
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
        want = cfg.num_hidden_layers if decision.fwd == "pallas" else 0
        if launched != want:
            sys.exit(f"chip_smoke: {launched} K1 launches in one generate, "
                     f"expected {want} (router: fwd={decision.fwd})")
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


def phase_epilogue(decisions):
    """incubate's fused_attention_rms_epilogue at the serving prefill and
    training attention shapes (forward only); returns K2's launches over
    the two calls. Each call launches K2 once where the ledger marks the
    fusion a winner, else never; its output is held against the unfused
    composition (dense attention, then the epilogue in torch)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    launches = 0
    for i, (name, case) in enumerate((("prefill", PREFILL),
                                      ("train", TRAIN_ATTN))):
        (q, k, v), _, _ = case_inputs(case, gen)
        res, w = epilogue_inputs(case, 200 + i)
        fa.flash_fwd_rms_epilogue_launches = 0     # the path starts here
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = IF.fused_attention_rms_epilogue(q, k, v, res, w,
                                                  epsilon=RMS_EPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launched = fa.flash_fwd_rms_epilogue_launches   # and ends here
        launches += launched
        want = 1 if decisions[name][1] else 0
        with torch.inference_mode():
            kx, vx = IF._expand_gqa(k, v, case["h"])
            ref = torch_epilogue(IF._sdpa_dense(q, kx, vx, case["causal"]),
                                 res, w).float()
        got = out.float()
        gmax = w.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = (out.shape == q.shape and out.dtype == q.dtype
              and bool(torch.isfinite(got).all())
              and bool(((got - ref).abs() <= K2_ATOL * gmax
                        + K2_RTOL * ref.abs()).all()))
        log(f"fused_attention_rms_epilogue {case_name(case)}: "
            f"{tuple(out.shape)} in {secs * 1e3:.3f} ms, K2 launches "
            f"{launched} (expected {want}), max|err| vs unfused "
            f"{err:.3e} {'ok' if ok else 'FAIL'}")
        if launched != want:
            sys.exit(f"chip_smoke: {launched} K2 launches in one "
                     f"fused_attention_rms_epilogue call, expected {want}")
        if not ok:
            sys.exit("chip_smoke: fused_attention_rms_epilogue disagrees "
                     "with the unfused composition")
    return launches


def phase_tiny_train():
    """The training step of a tiny llama (GQA, head dim 32: padded to 64
    where the router picks the kernels) in bf16 on the card against the
    same weights in f32 on the CPU: the loss, every gradient, and one AdamW
    step (moments and parameters)."""
    pt.seed(2)
    gpu = pt.models.llama_tiny(dtype="bfloat16", device="cuda")
    cpu = pt.models.llama_tiny(device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in gpu.state_dict().items()})
    ids = np.random.RandomState(2).randint(0, 512, (2, 128))
    runs = []
    for model in (gpu, cpu):
        params, loss_fn = build_scanned_llama(model, remat=True)
        opt = optimizer.AdamW(TINY_LR, parameters=model.parameters())
        state = opt.tree_init(params)
        x = torch.as_tensor(ids, device=next(iter(params["embed"].values()))
                            .device)
        loss = loss_fn(params, x, x)
        loss.backward()
        grads = {k: {n: t.grad for n, t in group.items()}
                 for k, group in params.items()}
        opt.tree_update(params, grads, state, TINY_LR, 1)
        runs.append((loss.item(), grads, state, params))
    (l_gpu, g_gpu, s_gpu, p_gpu), (l_cpu, g_cpu, s_cpu, p_cpu) = runs
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = moment_err = 0.0
    params_ok = True
    for group in g_cpu:
        for n, ref in g_cpu[group].items():
            scale = ref.abs().max().item() or 1.0
            grad_err = max(grad_err, (g_gpu[group][n].float().cpu() - ref)
                           .abs().max().item() / scale)
            m_ref = s_cpu[group][n]["moment1"]
            m_scale = m_ref.abs().max().item() or 1.0
            moment_err = max(moment_err, (s_gpu[group][n]["moment1"].float()
                                          .cpu() - m_ref).abs().max().item()
                             / m_scale)
            want = p_cpu[group][n].detach()
            got = p_gpu[group][n].detach().float().cpu()
            params_ok &= bool(((got - want).abs() <= 2 * TINY_LR + 2 ** -7
                               * torch.maximum(got.abs(), want.abs())).all())
    ok = (loss_err <= TINY_LOSS_RTOL and grad_err <= TINY_GRAD_RTOL
          and moment_err <= TINY_GRAD_RTOL and params_ok)
    log(f"tiny llama training step, bf16 on card vs f32 on CPU: loss "
        f"{l_gpu:.5f} vs {l_cpu:.5f} (rel err {loss_err:.2e}, tol "
        f"{TINY_LOSS_RTOL}); max grad err/max|grad| {grad_err:.2e}, "
        f"moment1 {moment_err:.2e} (tol {TINY_GRAD_RTOL}); params after "
        f"AdamW within 2 lr + 2^-7 |p|: {params_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        sys.exit("chip_smoke: the tiny training step on the card disagrees "
                 "with the CPU")
    # the tiny models' shapes miss the ledger: the router timed them here
    for key, dec in ar.decision_log():
        if dec.source == "measured-cuda":
            log(f"router {key}: fwd={dec.fwd} bwd={dec.bwd}, "
                f"{dec.provenance}")


def phase_train(decision):
    """llama_1.3b trained through train_llama.run_one; returns each kernel's
    launches over the run. `decision` is the router's at the training
    attention shape, which sets the launches each step must make."""
    gc.collect()
    torch.cuda.empty_cache()
    name, cfg, batch, seq, steps, remat = train_llama.llama_ladder()[0]
    n_layers = cfg.num_hidden_layers
    # the training path starts here
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    r = train_llama.run_one(cfg, batch, seq, steps, remat,
                            loss_chunk_mb=train_llama.loss_chunk_mb_for(name),
                            device="cuda")
    launches = train_llama.launch_counts()     # the training path ends here
    secs = r["seconds"]
    log(f"train {name}: {r['n_params']} params, {n_layers} layers, b{batch} "
        f"s{seq}, remat {remat}, loss path {r['lm_loss_path']}; set-up "
        f"{secs['setup']:.2f} s, warm-up step {secs['warmup']:.2f} s, "
        f"{steps} steps {secs['steps']:.2f} s")
    log(f"train {name}: step {r['step_time_s'] * 1e3:.1f} ms, "
        f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f}, peak memory "
        f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches {launches}")
    log(f"train {name}: losses {r['losses']}")
    fwd = decision.fwd == "pallas"
    bwd = fwd and decision.bwd == "pallas"
    want = {"flash_fwd": 2 * n_layers if fwd else 0,
            "flash_bwd_dq": n_layers if bwd else 0,
            "flash_bwd_dkv": n_layers if bwd else 0}
    if not all(np.isfinite(r["losses"])):
        sys.exit("chip_smoke: a training loss is not finite")
    if not r["losses"][-1] < r["losses"][0]:
        sys.exit("chip_smoke: the training loss did not fall")
    if r["lm_loss_path"] != "chunked":
        sys.exit("chip_smoke: llama_1.3b at b8 s2048 must take the chunked "
                 "LM loss")
    for i, per_step in enumerate(r["launches_per_step"]):
        if per_step != want:
            sys.exit(f"chip_smoke: step {i + 2} launched {per_step}, "
                     f"expected {want}")
    return launches


def main():
    phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    k34 = phase_k34()
    decisions = phase_router()
    phase_tiny_reference()
    phase_tiny_train()
    serve = phase_slice(decisions["prefill"][0])
    epilogue = phase_epilogue(decisions)
    train = phase_train(decisions["train"][0])
    src = "paddle_tpu_torch/csrc/flash_attention_"
    ref = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K1 runs on both paths; its times are the training shape's. K2's are
    # the serving prefill shape's (no single library call computes it).
    # "ms" and "library_ms" are device times from back-to-back calls
    kernels = [dict(name="flash_fwd", route="cuda", source=src + "fwd.cu",
                    replaces=ref + "116",
                    launches=serve + train["flash_fwd"],
                    **{key: k1["train"][key] for key in keys}),
               dict(name="flash_fwd_rms_epilogue", route="cuda",
                    source=src + "fwd.cu", replaces=ref + "116",
                    launches=epilogue,
                    **{key: k2["prefill"][key] for key in keys}),
               dict(name="flash_bwd_dq", route="cuda", source=src + "bwd.cu",
                    replaces=ref + "198", launches=train["flash_bwd_dq"],
                    **k34["dq"]),
               dict(name="flash_bwd_dkv", route="cuda", source=src + "bwd.cu",
                    replaces=ref + "249", launches=train["flash_bwd_dkv"],
                    **k34["dkv"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

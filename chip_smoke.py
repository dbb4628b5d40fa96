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
  9. serving engine: the same llama_7b served through
     ContinuousBatchingEngine (8 lanes, blocks of 16, 128 blocks a
     sequence, 1,040 blocks, prefill buckets 64-512 and chunks of 512,
     decode_steps 4): 16 requests of 64 new tokens with prompts of 64-1536
     tokens from RandomState(0), 12 greedy and 4 sampled (temperature 0.8,
     top_k 50, top_p 0.9), half added before the first step and half after
     the third. Three runs: two at decode_steps 4 (the second traced over
     its decode window) and one at decode_steps 1. Every request must end
     with 64 tokens in the vocabulary; the runs must give the same
     streams; every decode graph (greedy and sampled, K 1 and 4) replayed
     must give the tile the same program gives eagerly on the same lane
     state; each prompt's first-chunk logits must agree with the dense
     model forward within ENGINE_LOGITS_RTOL; K1-K4 must not launch from
     the first add_request to the last token; lane-state uploads must not
     outnumber membership changes. Prints prefill-chunk and decode-tile
     device times, tokens/s, TTFT and TPOT medians, the device's busy
     share over the decode window, peak memory and graph captures, and the
     same for generate at batch 8.
  9b. engine knobs, on the same model and engine knobs, every decode
     program a captured CUDA graph and no K1-K4 launch from the first
     add_request to the last token: speculative decode (depth 2, 3-grams)
     on phase 9's mix, whose streams must be phase 9's at decode_steps 4
     and 1, and on 8 greedy requests whose 512-token prompts tile one
     5-token motif (128 new tokens), against the same engine without
     speculation; int8 and fp8_e4m3 pools at the bf16 pool's bytes, which
     must hold 1.9x its blocks, give first-chunk logits within
     QUANT_LOGITS_RTOL of the bf16 pool's and the same streams with and
     without speculation, and one int8 run with serve.kv_dequant forced
     through FLAGS_fault_injection, which must capture again and finish
     every stream; an AdapterStore from demo_store_for_engine (4 adapters
     of rank 8, 8 slots) under 4 base and 4 adapter requests, whose base
     lanes must equal the storeless engine's and adapter lanes repeat
     across two runs, with a fifth adapter registered and served mid-run
     adding no capture; the prefix cache on and off over 8 requests that
     share a 1,024-token prefix (one of them exactly the prefix, so a COW
     fork happens), equal streams; and the SLO scheduler on phase 9's mix
     with 4 best_effort requests and speculation, one forced preemption
     and the ladder stepped to disable_speculation, streams equal to a run
     without them and one capture per program key. Prints, for each run,
     tokens/s, tokens per dispatch, acceptance, TTFT and TPOT medians,
     peak memory and graph captures, and the device time of every decode
     graph, beside the card's name and power limit.
  10. fused epilogue: incubate's fused_attention_rms_epilogue at llama_7b's
     attention widths (b4 s512, 32 heads of 128) and at llama_1.3b's
     training attention shape (b8 s2048, 16 heads), bf16, residual and
     gamma from a seeded numpy draw: one K2 launch per call where the
     ledger marks the fusion a winner, the output against the unfused
     composition.
  12. load generation: llama_7b through ContinuousBatchingEngine at phase
     9's knobs (decode_steps 4, an admission queue of 64) under
     inference.loadgen.run_scenario, each of the six SCENARIOS at its own
     distributions for 8 s of schedule on a fresh engine (shared_prefix
     with the prefix cache, structured_output under an SLOScheduler whose
     ladder only the cost model's headroom moves, a rung a step each way;
     multi_adapter on a cold
     engine without a store, so loadgen installs the demo store). Every
     report must pass loadgen.check_report (the prefix hit rate and
     adapter loads where they apply), and no K1-K4 launch. Then chat at
     5, 10, 20, 40 and 80 requests/s, 6 s each without draining: in every
     run slo_headroom must reach <= 0 no later than the timeline sample
     where shed passes 10%, and its median over the run must separate the
     rates: > 0 at the lowest rate (about half the saturated goodput_rps)
     and <= 0 at every rate that sheds more than 10% (at least one
     does). In every
     run each program's pir_cost_ratio at its end (its last dispatch's
     CUDA-event time over the calibrated price) must lie in [0.2, 5].
     Prints per run
     goodput, TTFT and TPOT p50/p95, shed, the headroom floor and median,
     the calibration scale of each kind of program (graph replays, eager
     prefill chunks), each program's calibrated cost and ratio, and
     adapter swap recompiles.
  13. predictor: the same llama_7b saved by jit.save (InputSpec [4, 512]
     int64; a torch.export program that takes the params as an input)
     into a temporary directory, then create_predictor(Config(prefix)) on
     the card, run twice on phase 8's prompts: the runs must agree bit for
     bit, the logits must agree with the model's eager forward within
     PREDICTOR_LOGITS_RTOL of the largest |logit|, the program must hold
     the flash_fwd operator once per layer, and K1 must launch once per
     layer per run where the router picks it at this shape. Prints save
     and load seconds, the artifact's bytes, the run's and the eager
     forward's device times and the run's peak memory.
  11. training slice: llama_1.3b (bench.py's top rung) in bf16 at full
     width and depth, batch 8, sequence 2048, per-layer remat, chunked LM
     loss, AdamW: one warm-up step and 8 timed steps through
     paddle_tpu_torch.tools.train_llama.run_one. Every loss must be finite,
     the last below the first, and with the router's choice of the
     kernels each step must launch K1 twice per layer (forward and remat
     recompute) and K3 and K4 once per layer. It runs last, after 12 and
     13, once llama_7b is freed.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.models import build_scanned_llama
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        SLOScheduler, demo_store_for_engine)
from paddle_tpu_torch.inference import loadgen
from paddle_tpu_torch.inference.scheduler import level_index
from paddle_tpu_torch.profiler.phases import get_phase_accountant
from paddle_tpu_torch.observability.quantiles import quantile_from_cumulative
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention_router as ar
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import profile_serving, train_llama

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

# the continuous-batching engine's phase: llama_7b through
# ContinuousBatchingEngine at these knobs, serving ENGINE_REQUESTS requests
# of ENGINE_NEW tokens each, prompts of 64-1536 tokens from RandomState(0);
# the first half is added before the first step, the rest after the third
ENGINE = dict(max_batch=8, block_size=16, max_blocks_per_seq=128,
              num_blocks=1040, prefill_buckets=(64, 128, 256, 512),
              prefill_chunk=512)
ENGINE_REQUESTS = 16
ENGINE_NEW = 64
ENGINE_SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
ENGINE_SAMPLED_AT = (2, 5, 10, 13)      # 4 sampled requests, 2 a wave
# the engine's first-chunk logits against the dense model forward, both in
# bf16 on the card: the engine's paged attention takes f32 scores over the
# bf16 pool, the forward takes K1 or dense attention, and every product and
# residual add of 32 layers rounds to bf16 on both sides in another order,
# so each logit may differ by a few bf16 steps of the largest logit (2^-8
# relative): |err| <= ENGINE_LOGITS_RTOL * max|logit|
ENGINE_LOGITS_RTOL = 5e-2

# the engine-knobs phase (after phase 9), on phase 9's model and knobs:
# speculative decode at depth 2 over 3-grams; a second mix of 8 greedy
# requests whose 512-token prompts tile one 5-token motif (bench.py's
# decode A/B mix), 128 new tokens each
KNOB_SPEC = dict(speculative_decode=True, draft_depth=2, draft_ngram=3)
MOTIF_REQUESTS, MOTIF_PROMPT, MOTIF_NEW = 8, 512, 128
# quantized pools at the bf16 pool's bytes must hold this many times its
# blocks (int8: 4,096 payload + 64 scale bytes a token and head set,
# against 8,192)
QUANT_MIN_BLOCKS = 1.9
# each prompt's first-chunk logits with a quantized pool against the bf16
# pool's, relative to the largest |logit|. Quantization error of a stored
# K or V element: int8 rounds to 1/254 of its (token, head) absmax, about
# the size of a bf16 rounding of a large element, so int8 takes phase 9's
# tolerance for a bf16 pool against the dense forward; fp8 e4m3 keeps 3
# mantissa bits, a relative step of 2^-3 (16 times bf16's 2^-7), so its
# tolerance is four times int8's (the error of sums of many such
# roundings grows as the square root of their count)
QUANT_LOGITS_RTOL = {"int8": ENGINE_LOGITS_RTOL,
                     "fp8_e4m3": 4 * ENGINE_LOGITS_RTOL}
# the kv-dequant degradation is forced on this decode phase's hit of the
# serve.kv_dequant site (FLAGS_fault_injection)
KV_DEQUANT_FAULT = "serve.kv_dequant:6:TimeoutError"
# adapters: demo_store_for_engine with 4 adapters of rank 8 in 8 slots.
# Its default scale 0.5 is sized for hidden 64; at hidden 4096 the delta
# x A B would be about 35 times the base projection, so the factors here
# are scaled to 0.05, a delta of the base projection's order
ADAPTERS = dict(names=["ad0", "ad1", "ad2", "ad3"], rank=8, n_slots=8,
                scale=0.05)
# prefix cache: 8 requests share a 1,024-token system prefix, with tails
# of 64-256 tokens; one request is exactly the prefix. The engine prefills
# at one width (512): a block-aligned full match re-runs only the last
# prompt position, and in a chunk of another width the bf16 products would
# round it differently from the cache-off run; at one width every
# position's forward is the same whichever chunk holds it
PREFIX_LEN, PREFIX_TAILS = 1024, (64, 96, 128, 160, 192, 224, 256, 0)
PREFIX_BUCKETS = (512,)
# load generation (phase 12): every scenario for this many seconds of
# schedule at phase 9's knobs with a bounded admission queue (overload is
# shed by backpressure, as the reference harness's engine sheds it), then
# chat at each sweep rate without draining (5 requests/s is about half
# the engine's saturated goodput_rps on the H100, 10 is about all of it);
# the floors check_report takes for the shared_prefix and multi_adapter
# scenarios are the reference CLI's defaults. A program's measured over
# predicted cost must lie in COST_RATIO_BAND, the band the CPU tests hold
# a prediction across prefill widths to
LOADGEN_SECONDS = 8.0
LOADGEN_QUEUE = 64
SWEEP_RATES, SWEEP_SECONDS = (5.0, 10.0, 20.0, 40.0, 80.0), 6.0
COST_RATIO_BAND = (0.2, 5.0)
MIN_PREFIX_HIT_RATE, MIN_ADAPTER_LOADS = 0.5, 1
# the predictor phase (13): the saved llama_7b runs phase 8's prompts; its
# logits against the model's eager forward, both bf16 on the card through
# the same kernels, relative to the largest |logit|: the exported program
# runs the forward's aten ops, so the two should agree to the bit, and the
# bound is phase 9's bf16 tolerance for two forwards that round in another
# order
PREDICTOR_SPEC = ([4, 512], "int64")
PREDICTOR_LOGITS_RTOL = ENGINE_LOGITS_RTOL


# the card's name and power limit as nvidia-smi gives them (phase 1)
CARD = "not read"


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log("nvidia-smi:", CARD)
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


def build_llama_7b():
    """llama_7b in bf16 at full width and depth, random weights from
    seed(0): the model of the serving phases."""
    pt.seed(0)
    t0 = time.perf_counter()
    model = pt.models.llama_7b(dtype="bfloat16", device="cuda")
    model.eval()
    torch.cuda.synchronize()
    cfg = model.config
    log(f"llama_7b: {model.num_params()} params, {cfg.num_hidden_layers} "
        f"layers, hidden {cfg.hidden_size}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def phase_slice(decision, model):
    """llama_7b serving 4 x 512-token prompts; returns K1's launches over
    the main path. `decision` is the router's at the prefill shape: each
    generate launches K1 once per layer if its forward is the kernel, else
    never."""
    cfg = model.config
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


def flash_launches():
    """K1 + K2 + K3 + K4 launches since their counters were last set."""
    return (fa.flash_fwd_launches + fa.flash_fwd_rms_epilogue_launches
            + fa.flash_bwd_dq_launches + fa.flash_bwd_dkv_launches)


def zero_flash_launches():
    fa.flash_fwd_launches = fa.flash_fwd_rms_epilogue_launches = 0
    fa.flash_bwd_dq_launches = fa.flash_bwd_dkv_launches = 0


def kernel_ms_traced(fn):
    """Summed kernel time (ms) of fn() under torch.profiler, None if the
    profiler saw no kernel. Kernels only: the host ops that launched them
    carry the same device time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
          for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(u for u in us if u > 0)
    return total / 1e3 if total else None


def engine_traffic(vocab):
    """The engine phase's 16 prompts (lengths 64-1536 and ids from
    RandomState(0)) and each request's knobs."""
    rs = np.random.RandomState(0)
    lengths = rs.randint(64, 1537, ENGINE_REQUESTS)
    prompts = [rs.randint(0, vocab, n) for n in lengths]
    knobs = [dict(ENGINE_SAMPLED, seed=100 + i) if i in ENGINE_SAMPLED_AT
             else {} for i in range(ENGINE_REQUESTS)]
    return prompts, knobs


def serve_traffic(model, prompts, knobs, decode_steps, on_step=None):
    """One engine run of the phase's traffic: half the requests before the
    first step, the rest after the third. Returns the engine, the streams,
    the K1-K4 launches from the first add_request to the last token, the
    host-clock wall of the run and of its decode window (the steps after
    the last prefill chunk), and the window's first step."""
    eng = ContinuousBatchingEngine(model, decode_steps=decode_steps,
                                   **ENGINE)
    half = ENGINE_REQUESTS // 2
    torch.cuda.synchronize()
    zero_flash_launches()                    # the path starts here
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=ENGINE_NEW, **kw)
            for p, kw in zip(prompts[:half], knobs[:half])]
    steps, window = 0, None
    while eng.has_work():
        eng.step()
        steps += 1
        if steps == 3:
            rids += [eng.add_request(p, max_new_tokens=ENGINE_NEW, **kw)
                     for p, kw in zip(prompts[half:], knobs[half:])]
        if (window is None and steps > 3 and not eng.queue
                and not eng._prefill_tasks):
            torch.cuda.synchronize()
            window = (steps + 1, time.perf_counter())
        if on_step is not None:
            on_step(eng, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = flash_launches()              # and ends at the last token
    streams = [eng.finished[r].generated for r in rids]
    reasons = [eng.finished[r].finish_reason for r in rids]
    return dict(engine=eng, streams=streams, reasons=reasons, steps=steps,
                launches=launches, wall=t1 - t0, window_step=window[0],
                window_wall=t1 - window[1])


def graph_matches_eager(eng):
    """Each decode program, greedy and sampled at K 1 and 4, replayed from
    its graph and run eagerly on the same lane state must give the same
    tile. The lane state is restored after each run, so the engine goes on
    as if neither had happened."""
    with torch.no_grad():
        eng._drain_all()
        if eng._dirty:
            eng._upload_lane_state(eng._decode_active())
        snap = {k: v.clone() for k, v in eng._dev.items()}

        def restore():
            for k, v in snap.items():
                eng._dev[k].copy_(v)
        same = []
        for sampled in (False, True):
            for k in (1, 4):
                prog = eng._graphs.get((sampled, k, 0))
                if prog is None:
                    prog = eng._graphs[(sampled, k, 0)] = eng._capture(
                        sampled, k)
                    eng.graph_captures += 1
                restore()
                prog.graph.replay()
                replayed = prog.tile.clone()
                restore()
                eager = eng._decode_tile(sampled, k)
                restore()
                same.append(((sampled, k), torch.equal(replayed, eager),
                             int(eng._dev["alive"].sum())))
    return same


def engine_device_ms(eng):
    """CUDA-event medians, on the engine of a finished run, of one prefill
    chunk of 512 tokens and of one decode tile, greedy and sampled, over
    all 8 lanes at position 1,024 (profile_serving.lane_state), the lane
    state restored before each replay."""
    d = eng._dev
    reset_greedy = profile_serving.lane_state(eng, eng.embed_w.shape[0])

    def reset_sampled():
        reset_greedy()
        d["do_sample"].fill_(True)
        d["seeds"].copy_(torch.arange(eng.max_batch, device=eng.device))
        d["temp"].fill_(ENGINE_SAMPLED["temperature"])
        d["top_k"].fill_(ENGINE_SAMPLED["top_k"])
        d["top_p"].fill_(ENGINE_SAMPLED["top_p"])
    ids = torch.as_tensor(np.random.RandomState(3).randint(
        0, eng.embed_w.shape[0], (1, 512)), device=eng.device)
    with torch.no_grad():
        reset_greedy()
        table = d["tables"][0].clone()
        chunk_ms = profile_serving.median_ms(
            lambda: eng._prefill_chunk(ids, 0, 511, table), reset_greedy)
        tile_ms = {}
        for sampled, reset in ((False, reset_greedy), (True, reset_sampled)):
            key = (sampled, eng.decode_steps, 0)
            if key not in eng._graphs:
                eng._graphs[key] = eng._capture(*key)
                eng.graph_captures += 1
            tile_ms["sampled" if sampled else "greedy"] = \
                profile_serving.median_ms(eng._graphs[key].graph.replay,
                                          reset)
    for lane in range(eng.max_batch):
        eng.pool.release(lane)
    return chunk_ms, tile_ms


def chunk_logits_check(eng, model, prompts):
    """Each prompt's first chunk through the engine's prefill program (into
    blocks reserved for the check) against the dense model forward: the
    logits of the chunk's last position. Returns the largest error over
    the largest |logit| and the engine's logits of each prompt."""
    worst, logits = 0.0, []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            n = min(len(p), eng.chunk)
            table = torch.full((ENGINE["max_blocks_per_seq"],),
                               eng.pool.scratch_block, dtype=torch.int64)
            t = eng.pool.ensure(("check", i), n)
            table[:len(t)] = torch.as_tensor(t)
            ids = torch.as_tensor(p[:n], device=eng.device)[None]
            got = eng._prefill_chunk(ids, 0, n - 1, table.to(eng.device))
            want = model(ids)[0, n - 1].float()
            eng.pool.release(("check", i))
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                sys.exit("chip_smoke: non-finite first-chunk logits")
            worst = max(worst, (got - want).abs().max().item()
                        / want.abs().max().item())
            logits.append(got)
    return worst, logits


def hist_median(name):
    fam = obs.get_registry().get(name)
    if fam is None or not fam.count:
        return None
    return quantile_from_cumulative(fam.cumulative_buckets(), 0.5)


def phase_engine(model):
    """llama_7b served through ContinuousBatchingEngine: chunked prefill
    into the paged bf16 pool, and the fused K-step decode replayed from
    one CUDA graph per (variant, K). Three runs of the traffic: two at
    decode_steps 4 (timed; the second traced over its decode window) and
    one at decode_steps 1, which also holds every decode graph against
    the same program run eagerly. Then generate at the same batch, for
    comparison. Returns run 1's streams and each prompt's first-chunk
    logits, which the knob phase holds its engines against."""
    cfg = model.config
    prompts, knobs = engine_traffic(cfg.vocab_size)
    log(f"engine: {ENGINE_REQUESTS} requests, prompts {min(map(len, prompts))}"
        f"-{max(map(len, prompts))} tokens ({sum(map(len, prompts))} in "
        f"all), {ENGINE_NEW} new tokens each, sampled at "
        f"{list(ENGINE_SAMPLED_AT)} ({ENGINE_SAMPLED}), knobs {ENGINE}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.get_registry().reset()
    obs.enable()
    a = serve_traffic(model, prompts, knobs, 4)
    peak = torch.cuda.max_memory_allocated()
    reg = obs.get_registry()
    uploads = reg.get("serving_lane_state_uploads_total").value
    dispatches = reg.get("serving_decode_dispatches_total").value
    ttft, tpot = (hist_median("serving_ttft_seconds"),
                  hist_median("serving_tpot_seconds"))
    obs.disable()
    eng = a["engine"]
    captures = eng.graph_captures
    chunk_ms, tile_ms = engine_device_ms(eng)
    worst, chunk_logits = chunk_logits_check(eng, model, prompts)
    del eng, a["engine"]
    gc.collect()
    torch.cuda.empty_cache()

    def traced_window(e, step):
        if step + 1 == b_window[0]:
            b_window[1] = kernel_ms_traced(
                lambda: [e.step() for _ in range(b_window[2])])
    b_window = [a["window_step"], None, a["steps"] - a["window_step"] + 1]
    b = serve_traffic(model, prompts, knobs, 4, on_step=traced_window)
    del b["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    checks = []
    c = serve_traffic(model, prompts, knobs, 1, on_step=lambda e, step: (
        checks.extend(graph_matches_eager(e)) if step == 6 else None))
    del c["engine"]
    gc.collect()
    torch.cuda.empty_cache()

    tokens = sum(map(len, a["streams"]))
    K, B = 4, ENGINE["max_batch"]
    busy = (None if b_window[1] is None
            else b_window[1] / 1e3 / a["window_wall"])
    log(f"engine: prefill chunk of 512 tokens {chunk_ms:.3f} ms (CUDA "
        f"events, median of 5)")
    log(f"engine: decode tile K={K} over {B} lanes {tile_ms['greedy']:.3f} "
        f"ms greedy, {tile_ms['sampled']:.3f} ms sampled (graph replay, "
        f"CUDA events, median of 5): {tile_ms['greedy'] / K:.3f} ms per "
        f"token per lane, {tile_ms['greedy'] / (K * B):.4f} ms per token")
    log(f"engine: {tokens} tokens in {a['wall']:.3f} s, "
        f"{tokens / a['wall']:.1f} tokens/s ({a['steps']} steps, host "
        f"clock, prefill included); TTFT median "
        f"{ttft if ttft is None else f'{ttft:.4f}'} s, TPOT median "
        f"{tpot if tpot is None else f'{tpot:.5f}'} s (catalog "
        f"histograms, bucket-interpolated)")
    log(f"engine: decode window steps {a['window_step']}-{a['steps']} "
        f"{a['window_wall'] * 1e3:.1f} ms host clock, kernels "
        + ("not measured (the profiler saw no kernel)" if busy is None else
           f"{b_window[1]:.1f} ms (traced twin run), device busy {busy:.1%}"))
    log(f"engine: peak memory {peak / 2**30:.2f} GiB, graph captures "
        f"{captures}, lane-state uploads {uploads:.0f} (membership changes at "
        f"most {2 * ENGINE_REQUESTS}), decode dispatches {dispatches:.0f} "
        f"(run 1); K1-K4 launches {a['launches']}, {b['launches']}, "
        f"{c['launches']} (runs 1, 2 and decode_steps 1)")
    log(f"engine: first-chunk logits vs the dense forward: max|err| / "
        f"max|logit| {worst:.3e} (tol {ENGINE_LOGITS_RTOL})")
    log("engine: graph replay vs eager tile " + ", ".join(
        f"{'sampled' if s else 'greedy'} K{k} {'same' if ok else 'DIFFERENT'}"
        f" ({n} lanes alive)" for (s, k), ok, n in checks))
    for name, run in (("run 1", a), ("run 2", b), ("decode_steps 1", c)):
        if any(len(s) != ENGINE_NEW for s in run["streams"]) or any(
                r != "length" for r in run["reasons"]):
            sys.exit(f"chip_smoke: engine {name}: a request did not finish "
                     f"with {ENGINE_NEW} tokens")
        if any(t < 0 or t >= cfg.vocab_size for s in run["streams"]
               for t in s):
            sys.exit(f"chip_smoke: engine {name}: a token id is out of the "
                     f"vocabulary")
        if run["launches"] != 0:
            sys.exit(f"chip_smoke: engine {name} launched K1-K4 "
                     f"{run['launches']} times")
    if a["streams"] != b["streams"]:
        sys.exit("chip_smoke: two engine runs with the same seeds differ")
    if a["streams"] != c["streams"]:
        sys.exit("chip_smoke: engine streams differ between decode_steps 4 "
                 "and 1")
    if not checks or not all(ok for _, ok, _ in checks):
        sys.exit("chip_smoke: a decode tile replayed from its graph differs "
                 "from the same tile run eagerly")
    if uploads > 2 * ENGINE_REQUESTS:
        sys.exit("chip_smoke: more lane-state uploads than membership "
                 "changes")
    if not worst <= ENGINE_LOGITS_RTOL:
        sys.exit("chip_smoke: engine first-chunk logits disagree with the "
                 "dense forward")
    phase_engine_generate(model, tokens_per_lane=ENGINE_NEW)
    return a["streams"], chunk_logits


def phase_engine_generate(model, tokens_per_lane):
    """generate at the engine phase's batch (8 prompts of 512 tokens,
    `tokens_per_lane` new tokens), for comparison: its prefill is its
    TTFT and its decode step its TPOT."""
    gc.collect()
    torch.cuda.empty_cache()
    b, s = ENGINE["max_batch"], 512
    ids = torch.as_tensor(np.random.RandomState(1).randint(
        0, model.config.vocab_size, (b, s)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for n in (1, tokens_per_lane):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generation.generate(model, ids, max_new_tokens=n)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    decode_s = (secs[1] - secs[0]) / (tokens_per_lane - 1)
    short = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generation.generate(model, ids, max_new_tokens=short)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traced = kernel_ms_traced(
        lambda: generation.generate(model, ids, max_new_tokens=short))
    log(f"generate b{b} s{s}, {tokens_per_lane} new tokens: prefill (TTFT) "
        f"{secs[0] * 1e3:.1f} ms, decode step (TPOT) {decode_s * 1e3:.2f} "
        f"ms, {b * tokens_per_lane / secs[1]:.1f} tokens/s ({secs[1]:.3f} s, "
        f"host clock), peak memory {peak / 2**30:.2f} GiB, graph captures 0; "
        f"{short}-token call {wall * 1e3:.1f} ms, kernels "
        + ("not measured" if traced is None else
           f"{traced:.1f} ms, device busy {traced / 1e3 / wall:.1%}"))


def knob_traffic(vocab):
    """The knob phase's mixes: phase 9's 16 requests, the motif mix and
    the shared-prefix mix, as [(prompt, request knobs)]."""
    prompts, knobs = engine_traffic(vocab)
    mix9 = [(p, dict(kw, max_new_tokens=ENGINE_NEW))
            for p, kw in zip(prompts, knobs)]
    motif = np.random.RandomState(7).randint(0, vocab, (5,))
    mix_motif = [(np.tile(motif, MOTIF_PROMPT // 5 + 1)[:MOTIF_PROMPT],
                  dict(max_new_tokens=MOTIF_NEW))] * MOTIF_REQUESTS
    rs = np.random.RandomState(11)
    prefix = rs.randint(0, vocab, PREFIX_LEN)
    mix_prefix = [(np.concatenate([prefix, rs.randint(0, vocab, t)]),
                   dict(max_new_tokens=ENGINE_NEW)) for t in PREFIX_TAILS]
    return mix9, mix_motif, mix_prefix


def knob_run(model, reqs, plan="waves", on_step=None, engine=None, **kw):
    """One engine run of `reqs` through ContinuousBatchingEngine at phase
    9's knobs plus `kw` (or on `engine`). plan "waves": half the requests
    before the first step, the rest after the third (phase 9's); "all":
    every request at once; "first": one request, the rest once its prefill
    is done. Observability on, from zero. Returns the engine, the streams,
    finish reasons, K1-K4 launches from the first add_request to the last
    token, and the run's numbers."""
    eng = engine if engine is not None else ContinuousBatchingEngine(
        model, **{**ENGINE, "decode_steps": 4, **kw})
    obs.get_registry().reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = {"waves": len(reqs) // 2, "all": len(reqs), "first": 1}[plan]
    zero_flash_launches()                    # the path starts here
    t0 = time.perf_counter()
    rids = [eng.add_request(p, **rk) for p, rk in reqs[:first]]
    steps = 0
    while eng.has_work() or len(rids) < len(reqs):
        eng.step()
        steps += 1
        late = ((plan == "waves" and steps == 3)
                or (plan == "first" and not eng.queue
                    and not eng._prefill_tasks))
        if late and len(rids) < len(reqs):
            rids += [eng.add_request(p, **rk) for p, rk in reqs[first:]]
        if on_step is not None:
            on_step(eng, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_launches()              # and ends at the last token
    reg = obs.get_registry()

    def value(name):
        fam = reg.get(name)
        return 0.0 if fam is None else fam.value
    streams = [eng.finished[r].generated for r in rids]
    tokens = sum(map(len, streams))
    dispatches = value("serving_decode_dispatches_total")
    drafted = value("serving_draft_tokens_total")
    run = dict(
        engine=eng, streams=streams, launches=launches, wall=wall,
        reasons=[eng.finished[r].finish_reason for r in rids],
        tokens=tokens, steps=steps,
        # decode tokens (every token but each request's first, which its
        # prefill chooses) over decode dispatches
        per_dispatch=(tokens - len(rids)) / max(1.0, dispatches),
        acceptance=(value("serving_accepted_tokens_total") / drafted
                    if drafted else None),
        ttft=hist_median("serving_ttft_seconds"),
        tpot=hist_median("serving_tpot_seconds"),
        peak=torch.cuda.max_memory_allocated(),
        captures=eng.graph_captures, keys=sorted(eng.program_keys_used),
        prefix=dict(saved=value("serving_prefix_tokens_saved_total"),
                    shared=value("serving_prefix_shared_blocks"),
                    forks=value("serving_prefix_cow_forks_total"),
                    hits=value("serving_prefix_hits_total")))
    obs.disable()
    return run


def knob_report(name, run):
    """One line of a knob run's numbers, beside the card."""
    fmt = (lambda x, f: "not measured" if x is None else f.format(x))
    log(f"knobs {name} [{CARD}]: {run['tokens']} tokens in "
        f"{run['wall']:.3f} s, {run['tokens'] / run['wall']:.1f} tokens/s "
        f"(host clock, prefill included), {run["per_dispatch"]:.3f} tokens "
        f"per dispatch (all lanes), acceptance {fmt(run['acceptance'], '{:.4f}')}, "
        f"TTFT median {fmt(run['ttft'], '{:.4f}')} s, TPOT median "
        f"{fmt(run['tpot'], '{:.5f}')} s, peak memory "
        f"{run['peak'] / 2**30:.2f} GiB, graph captures {run['captures']} "
        f"for keys {run['keys']} (sampled, K, draft depth)")


def knob_check(name, run, want=None, new=None):
    """Fail the phase if a run launched K1-K4, a stream did not finish
    with its tokens in the vocabulary, or the streams differ from
    `want`."""
    if run["launches"] != 0:
        sys.exit(f"chip_smoke: knobs {name} launched K1-K4 "
                 f"{run['launches']} times")
    vocab = run["engine"].embed_w.shape[0]
    for s, reason, n in zip(run["streams"], run["reasons"],
                            new or [None] * len(run["streams"])):
        if reason != "length" or (n is not None and len(s) != n):
            sys.exit(f"chip_smoke: knobs {name}: a request ended "
                     f"{reason} with {len(s)} tokens")
        if any(t < 0 or t >= vocab for t in s):
            sys.exit(f"chip_smoke: knobs {name}: a token id is out of the "
                     "vocabulary")
    if want is not None and run["streams"] != want:
        bad = sum(a != b for a, b in zip(run["streams"], want))
        sys.exit(f"chip_smoke: knobs {name}: {bad} streams differ from the "
                 "run they must equal")


def graph_tile_ms(eng):
    """CUDA-event medians (5 replays) of every decode graph the engine
    captured, all 8 lanes alive at position 1,024 (profile_serving's lane
    state; sampled graphs with phase 9's sampling knobs, speculative ones
    over a history of motif tokens, adapter lanes on slots 0-7), the lane
    state restored before each replay."""
    d, B = eng._dev, eng.max_batch
    vocab = eng.embed_w.shape[0]
    reset_lanes = profile_serving.lane_state(eng, vocab)
    hist = None
    if "hist" in d:
        motif = np.random.RandomState(7).randint(0, vocab, (5,))
        hist = torch.as_tensor(np.tile(motif, d["hist"].shape[1] // 5 + 1)[
            :d["hist"].shape[1]], device=eng.device).expand(B, -1)
    out = {}
    with torch.no_grad():
        for key, prog in sorted(eng._graphs.items()):
            sampled, K, D = key

            def reset():
                reset_lanes()
                d["do_sample"].fill_(sampled)
                d["seeds"].copy_(torch.arange(B, device=eng.device))
                d["temp"].fill_(ENGINE_SAMPLED["temperature"])
                d["top_k"].fill_(ENGINE_SAMPLED["top_k"])
                d["top_p"].fill_(ENGINE_SAMPLED["top_p"])
                if hist is not None:
                    d["hist"].copy_(hist)
                if "adapter_ids" in d:
                    d["adapter_ids"].copy_(
                        torch.arange(B, device=eng.device)
                        % eng.adapters.n_slots)
            name = (("sampled" if sampled else "greedy") + f" K={K}"
                    + (f" spec D={D}" if D else ""))
            out[name] = profile_serving.median_ms(prog.graph.replay, reset)
    for lane in range(B):
        eng.pool.release(lane)
    log(f"knobs tiles, {eng.pool.fmt.name} pool"
        + (", adapter store" if eng.adapters is not None else "")
        + f" [{CARD}]: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in out.items())
        + " (graph replay over 8 lanes at position 1,024, CUDA events, "
        "median of 5)")
    return out


def free(*runs):
    """Drop the runs' engines and their pools."""
    for run in runs:
        run.pop("engine", None)
    gc.collect()
    torch.cuda.empty_cache()


def knobs_spec(model, mix9, mix_motif, plain9):
    """Speculative decode on phase 9's mix (against phase 9's plain
    streams, at decode_steps 4 and 1) and on the motif mix (against its
    own plain run)."""
    new9 = [ENGINE_NEW] * len(mix9)
    s4 = knob_run(model, mix9, **KNOB_SPEC)
    knob_report("spec mix16 K=4", s4)
    knob_check("spec mix16 K=4", s4, plain9, new9)
    graph_tile_ms(s4["engine"])
    free(s4)
    s1 = knob_run(model, mix9, **dict(KNOB_SPEC, decode_steps=1))
    knob_report("spec mix16 K=1", s1)
    knob_check("spec mix16 K=1", s1, plain9, new9)
    free(s1)
    newm = [MOTIF_NEW] * len(mix_motif)
    pm = knob_run(model, mix_motif, plan="all")
    knob_report("plain motif", pm)
    knob_check("plain motif", pm, new=newm)
    sm = knob_run(model, mix_motif, plan="all", **KNOB_SPEC)
    knob_report("spec motif", sm)
    knob_check("spec motif", sm, pm["streams"], newm)
    graph_tile_ms(sm["engine"])
    free(pm, sm)
    return s4, sm


def first_chunk_logits(eng, prompts):
    """Each prompt's first chunk through the engine's prefill program,
    into blocks reserved for the check: the chunk's last-position
    logits."""
    out = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            n = min(len(p), eng.chunk)
            table = torch.full((ENGINE["max_blocks_per_seq"],),
                               eng.pool.scratch_block, dtype=torch.int64)
            t = eng.pool.ensure(("check", i), n)
            table[:len(t)] = torch.as_tensor(t)
            ids = torch.as_tensor(p[:n], device=eng.device)[None]
            out.append(eng._prefill_chunk(ids, 0, n - 1,
                                          table.to(eng.device)))
            eng.pool.release(("check", i))
    return out


def knobs_quant(model, mix9, bf16_logits):
    """int8 and fp8_e4m3 pools at the bf16 pool's bytes: capacity, first-
    chunk logits against the bf16 pool's, spec streams against plain ones
    within each format, and one int8 run that forces the kv-dequant
    degradation, which must capture again and finish every stream."""
    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    bf16_bytes = (ENGINE["num_blocks"] * cfg.num_hidden_layers
                  * ENGINE["block_size"] * 2 * cfg.num_key_value_heads * hd
                  * 2)
    new9 = [ENGINE_NEW] * len(mix9)
    out = {}
    for fmt in ("int8", "fp8_e4m3"):
        kw = dict(kv_cache_dtype=fmt, kv_pool_bytes=bf16_bytes)
        q = knob_run(model, mix9, **kw)
        eng = q["engine"]
        ratio = eng.pool.num_blocks / ENGINE["num_blocks"]
        got = first_chunk_logits(eng, [p for p, _ in mix9])
        err = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, bf16_logits))
        knob_report(f"{fmt} plain", q)
        log(f"knobs {fmt} [{CARD}]: pool of {bf16_bytes} bytes holds "
            f"{eng.pool.num_blocks} blocks, {ratio:.3f}x the bf16 pool's "
            f"{ENGINE['num_blocks']}; first-chunk logits vs the bf16 pool: "
            f"max|err| / max|logit| {err:.3e} (tol "
            f"{QUANT_LOGITS_RTOL[fmt]})")
        knob_check(f"{fmt} plain", q, new=new9)
        graph_tile_ms(eng)
        if ratio < QUANT_MIN_BLOCKS:
            sys.exit(f"chip_smoke: the {fmt} pool holds {ratio:.3f}x the "
                     f"bf16 pool's blocks, below {QUANT_MIN_BLOCKS}")
        if not err <= QUANT_LOGITS_RTOL[fmt]:
            sys.exit(f"chip_smoke: {fmt} first-chunk logits disagree with "
                     "the bf16 pool's")
        free(q)
        qs = knob_run(model, mix9, **kw, **KNOB_SPEC)
        knob_report(f"{fmt} spec", qs)
        knob_check(f"{fmt} spec", qs, q["streams"], new9)
        graph_tile_ms(qs["engine"])
        free(qs)
        out[fmt] = (q, qs)
    pt.set_flags({"FLAGS_fault_injection": KV_DEQUANT_FAULT})
    try:
        f = knob_run(model, mix9, kv_cache_dtype="int8",
                     kv_pool_bytes=bf16_bytes, **KNOB_SPEC)
    finally:
        pt.set_flags({"FLAGS_fault_injection": ""})
    eng = f["engine"]
    knob_report("int8 spec, kv-dequant forced", f)
    knob_check("int8 spec, kv-dequant forced", f, new=new9)
    if eng.pool.fmt.quantized or f["captures"] <= len(f["keys"]):
        sys.exit("chip_smoke: the forced kv-dequant degradation did not "
                 "leave a native pool captured again")
    log(f"knobs kv-dequant [{CARD}]: pool now {eng.pool.k.dtype}, "
        f"{f['captures']} captures for {len(f['keys'])} keys")
    free(f)
    return out


def knobs_adapters(model, mix9):
    """An AdapterStore from demo_store_for_engine: 4 base lanes equal the
    storeless engine's streams, each adapter lane repeats across two runs,
    and a fifth adapter registered mid-run (a hot swap) adds no graph
    capture."""
    reqs = [(p, dict(kw, max_new_tokens=ENGINE_NEW))
            for p, kw in mix9[:8]]
    names = ADAPTERS["names"]
    plain = knob_run(model, reqs, plan="all")
    knob_report("adapters storeless", plain)
    knob_check("adapters storeless", plain, new=[ENGINE_NEW] * 8)
    store = demo_store_for_engine(plain["engine"], names,
                                  rank=ADAPTERS["rank"],
                                  n_slots=ADAPTERS["n_slots"],
                                  scale=ADAPTERS["scale"])
    free(plain)
    with_ad = [(p, dict(kw, adapter=names[i - 4] if i >= 4 else None))
               for i, (p, kw) in enumerate(reqs)]
    first = knob_run(model, with_ad, plan="all", adapters=store)
    engine = first.pop("engine")
    swap = {}

    def hot_swap(eng, step):
        if step == 3:
            swap["before"] = (eng.graph_captures,
                              set(eng.program_keys_used))
            r = np.random.RandomState(6)
            L, H, R = store.num_layers, store.hidden, store.rank
            store.register("ad4", *(
                r.randn(*shape).astype(np.float32) * ADAPTERS["scale"]
                for shape in ((L, H, R), (L, R, store.q_out), (L, H, R),
                              (L, R, store.v_out))))
            swap["rid"] = eng.add_request(reqs[0][0], max_new_tokens=16,
                                          adapter="ad4")
    hot = knob_run(model, with_ad, plan="all", engine=engine,
                   on_step=hot_swap)
    first["engine"] = engine
    swapped = engine.finished[swap["rid"]]
    slot = store.resident().get("ad4")
    knob_report("adapters store run 1", first)
    knob_report("adapters store run 2, hot swap", hot)
    for name, run in (("adapters store run 1", first),
                      ("adapters hot swap", hot)):
        knob_check(name, run, new=[ENGINE_NEW] * 8)
        if run["streams"][:4] != plain["streams"][:4]:
            sys.exit(f"chip_smoke: {name}: a base lane differs from the "
                     "storeless engine's")
    if first["streams"][4:] != hot["streams"][4:]:
        sys.exit("chip_smoke: an adapter lane differs between two runs")
    if first["streams"][4:] == plain["streams"][4:]:
        sys.exit("chip_smoke: the adapter lanes equal the base model's")
    # captures after the swap: only those of program keys first used
    # after it (a lane mix that turns all-greedy, say), never a recapture
    new_keys = set(hot["keys"]) - swap["before"][1]
    if (swapped.finish_reason != "length"
            or hot["captures"] - swap["before"][0] != len(new_keys)):
        sys.exit("chip_smoke: the hot swap did not serve, or added a "
                 "graph capture")
    log(f"knobs adapters [{CARD}]: base lanes equal the storeless "
        f"engine's; adapter lanes repeat; hot swap of ad4 into slot "
        f"{slot} added no capture ({hot['captures']} captures, "
        f"{len(new_keys)} for program keys first used after it); store "
        f"{store.stats()}")
    graph_tile_ms(engine)
    del engine
    free(first, hot)


def knobs_prefix(model, mix_prefix):
    """The shared-prefix mix with the prefix cache on and off: equal
    streams; prefill tokens saved, shared blocks, COW forks, TTFT."""
    new = [ENGINE_NEW] * len(mix_prefix)
    runs = {}
    for on in (False, True):
        run = knob_run(model, mix_prefix, plan="first", prefix_cache=on,
                       prefill_buckets=PREFIX_BUCKETS)
        name = f"prefix cache {'on' if on else 'off'}"
        knob_report(name, run)
        knob_check(name, run, runs.get(False, {}).get("streams"), new)
        log(f"knobs {name} [{CARD}]: prefill tokens saved "
            f"{run['prefix']['saved']:.0f}, hits {run['prefix']['hits']:.0f}"
            f", shared blocks {run['prefix']['shared']:.0f}, COW forks "
            f"{run['prefix']['forks']:.0f}, TTFT median "
            f"{run['ttft']:.4f} s")
        free(run)
        runs[on] = run
    if runs[True]["prefix"]["forks"] < 1 or runs[True]["prefix"]["saved"] < (
            len(mix_prefix) - 1) * (PREFIX_LEN - 1):
        sys.exit("chip_smoke: the prefix cache shared less than the prefix")
    return runs


def knobs_scheduler(model, mix9):
    """SLOScheduler on phase 9's mix with 4 best_effort requests, and
    speculation: a run without preemption, then one that forces a
    preemption and steps the ladder to disable_speculation (K 4 -> 2,
    depth 2 -> 1, no speculation) and lets it recover. Streams must be
    equal; captures must equal the distinct program keys."""
    reqs = [(p, dict(kw, priority="best_effort" if i % 4 == 3
                     else "interactive"))
            for i, (p, kw) in enumerate(mix9)]
    # wall-clock targets off and no escalation of the ladder's own: it
    # moves only where the script moves it (a TTFT breach, or the cost
    # model's headroom while a wave arrives, could engage
    # cap_max_new_tokens mid-run)
    sched = dict(ttft_target=1e9, tpot_target=1e9, escalate_after=10**9)
    base = knob_run(model, reqs, scheduler=SLOScheduler(**sched),
                    **KNOB_SPEC)
    knob_report("scheduler", base)
    knob_check("scheduler", base, new=[ENGINE_NEW] * len(reqs))
    free(base)
    forced = {}

    def drive(eng, step):
        # once the second wave is in: preempt a decoding lane, and on the
        # next step move the ladder
        if "preempt" in forced and "ladder" not in forced:
            # a transition starts the ladder's dwell and recovery streak,
            # so the rung holds for a few dispatches before it recovers
            eng.scheduler._transition(level_index("disable_speculation"),
                                      "up")
            eng.scheduler._apply(eng)
            forced["ladder"] = (eng.decode_steps, eng.draft_depth, eng.spec)
        elif step >= 4 and eng._decode_active() and "preempt" not in forced:
            forced["preempt"] = eng._try_preempt(eng._decode_active()[0],
                                                 why="drill")
    run = knob_run(model, reqs, on_step=drive,
                   scheduler=SLOScheduler(**sched), **KNOB_SPEC)
    eng = run["engine"]
    knob_report("scheduler, preempted and laddered", run)
    knob_check("scheduler, preempted and laddered", run, base["streams"],
               [ENGINE_NEW] * len(reqs))
    log(f"knobs scheduler [{CARD}]: preempted {forced.get('preempt')}, "
        f"ladder at disable_speculation gave (K, depth, spec) "
        f"{forced.get('ladder')}, back to level {eng.scheduler.level}; "
        f"transitions down {eng.scheduler.transitions_down}")
    if (not forced.get("preempt") or forced.get("ladder") != (2, 1, False)
            or not any(k[1:] == (2, 0) for k in run["keys"])
            or run["captures"] != len(run["keys"])):
        sys.exit("chip_smoke: the scheduler drill did not preempt, step "
                 "the ladder, or captured other than once per key")
    free(run)


def phase_knobs(model, plain9, bf16_logits):
    """The engine's knobs on llama_7b at phase 9's knobs: speculative
    decode, quantized KV, adapters, the prefix cache and the SLO
    scheduler. Every decode program is a captured CUDA graph; K1-K4 must
    not launch."""
    mix9, mix_motif, mix_prefix = knob_traffic(model.config.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    knobs_spec(model, mix9, mix_motif, plain9)
    knobs_quant(model, mix9, bf16_logits)
    knobs_adapters(model, mix9)
    knobs_prefix(model, mix_prefix)
    knobs_scheduler(model, mix9)
    log(f"knobs: phase done in {time.perf_counter() - t0:.1f} s")


def loadgen_engine(model, warm=True, **kw):
    """A fresh engine at phase 9's knobs with a bounded admission queue.
    With `warm`, two short requests run first, so the first dispatch of
    the run is not the decode graph's capture."""
    eng = ContinuousBatchingEngine(model, decode_steps=4,
                                   max_queue=LOADGEN_QUEUE, **ENGINE, **kw)
    if warm:
        eng.add_request(np.arange(1, 8), max_new_tokens=12)
        eng.add_request(np.arange(1, 21), max_new_tokens=12)
        eng.run()
        eng.finished.clear()
    return eng


def loadgen_run(eng, scenario, **kw):
    """run_scenario with observability and the phase accountant on, from
    zero; returns the report and the K1-K4 launches of the run."""
    obs.get_registry().reset()
    obs.enable()
    acct = get_phase_accountant()
    acct.reset()
    acct.enable()
    zero_flash_launches()                    # the path starts here
    try:
        report = loadgen.run_scenario(eng, scenario, seed=0, **kw)
    finally:
        launches = flash_launches()          # and ends here
        acct.disable()
        acct.reset()
        obs.disable()
    return report, launches


def cost_ratios(report):
    """{program: measured over predicted} for the programs this run's
    engine measured (the registry keeps the gauge of a program no
    dispatch of this run observed at the 0 of its reset)."""
    return {k.removeprefix("program="): round(v, 4)
            for k, v in sorted(report["cost"]["ratio"].items()) if v > 0}


def headroom_median(report):
    """The median of the run's slo_headroom samples (None if none)."""
    hs = [s["headroom"] for s in report["timeline"]
          if s["headroom"] is not None]
    return statistics.median(hs) if hs else None


def loadgen_line(name, report, eng):
    """One line of a run's numbers, beside the card."""
    def q(block, key):
        v = block.get(key)
        return "not measured" if v is None else f"{v:.4f}"
    costs = {k: (None if c["seconds"] is None else round(c["seconds"], 6))
             for k, c in sorted((report["cost"]["programs"] or {}).items())}
    scales = {k: round(v, 4) for k, v in (eng._cost_scale or {}).items()}
    ad = report.get("adapters") or {}
    pfx = report.get("prefix") or {}
    log(f"loadgen {name} [{CARD}]: {report['schedule']['arrivals']} "
        f"arrivals, issued {report['issued']}, finished "
        f"{report['finished']}, goodput {report['goodput']}, goodput_rps "
        f"{report['goodput_rps']}, TTFT p50/p95 {q(report['ttft'], 'p50')}"
        f"/{q(report['ttft'], 'p95')} s, TPOT p50/p95 "
        f"{q(report['tpot'], 'p50')}/{q(report['tpot'], 'p95')} s, shed "
        f"{report['shed']}, headroom_floor {report['headroom_floor']}, "
        f"headroom median {headroom_median(report)}, scales {scales}, "
        f"predicted s {costs}, pir_cost_ratio {cost_ratios(report)}, "
        f"swap_recompiles "
        f"{ad.get('swap_recompiles')}, prefix hit rate "
        f"{pfx.get('hit_rate')}, brownout transitions "
        f"{report['brownout_transitions']}, wall {report['wall_s']} s")


def cost_ratio_problems(report):
    """The programs whose measured over predicted cost left the band, or
    a run with no measured program."""
    ratios = cost_ratios(report)
    lo, hi = COST_RATIO_BAND
    bad = {k: v for k, v in ratios.items() if not lo <= v <= hi}
    if not ratios:
        return ["no program's pir_cost_ratio was measured"]
    return [f"pir_cost_ratio outside [{lo}, {hi}]: {bad}"] if bad else []


def headroom_leads_shed(report):
    """The timeline samples where slo_headroom first reached <= 0 and
    where the shed fraction first passed 10% (None where it never did)."""
    tl = report["timeline"]
    over = next((i for i, s in enumerate(tl) if s["headroom"] is not None
                 and s["headroom"] <= 0.0), None)
    shed = next((i for i, s in enumerate(tl) if s["shed_frac"] > 0.10),
                None)
    return over, shed


def phase_loadgen(model):
    """Every scenario of inference/loadgen.py through the engine, then the
    chat sweep across saturation. Returns the sweep's rows."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    knobs = {"shared_prefix": dict(prefix_cache=True),
             # the ladder moves on the cost model's headroom alone, a rung
             # a step each way, so it can come back to 0 while the run
             # drains (check_report fails a run that ends degraded)
             "structured_output": dict(scheduler=SLOScheduler(
                 ttft_target=1e9, tpot_target=1e9, escalate_after=1,
                 recover_after=1, min_dwell=0))}
    for name in sorted(loadgen.SCENARIOS):
        adapters = loadgen.SCENARIOS[name].adapter_population > 0
        eng = loadgen_engine(model, warm=not adapters, **knobs.get(name, {}))
        report, launches = loadgen_run(eng, name,
                                       duration_s=LOADGEN_SECONDS)
        loadgen_line(name, report, eng)
        problems = loadgen.check_report(
            report,
            min_prefix_hit_rate=(MIN_PREFIX_HIT_RATE
                                 if name == "shared_prefix" else None),
            min_adapter_loads=MIN_ADAPTER_LOADS if adapters else None)
        problems += cost_ratio_problems(report)
        if launches:
            problems.append(f"{launches} K1-K4 launches in the engine run")
        if problems:
            sys.exit(f"chip_smoke: loadgen {name} failed its check: "
                     f"{problems}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rows = []
    for rate in SWEEP_RATES:
        eng = loadgen_engine(model)
        report, launches = loadgen_run(eng, "chat", rate_rps=rate,
                                       duration_s=SWEEP_SECONDS,
                                       drain=False)
        loadgen_line(f"chat at {rate:g} rps", report, eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        over, shed = headroom_leads_shed(report)
        attempts = report["issued"] + report["rejected"]
        # goodput as the share of the offered requests that finished good
        # inside the run (report["goodput"] counts finished requests
        # only, so a run that refuses or queues most of its traffic still
        # reads 1.0; here a refused request, and one still queued or in
        # flight when the run stops, counts against it)
        good = sum(report["finished"].get(r, 0)
                   for r in loadgen.GOOD_REASONS)
        rows.append(dict(rate=rate, goodput=good / max(1, attempts),
                         goodput_rps=report["goodput_rps"],
                         shed=report["shed"],
                         shed_frac=report["shed"] / max(1, attempts),
                         floor=report["headroom_floor"],
                         median=headroom_median(report)))
        log(f"loadgen sweep [{CARD}]: {rate:g} rps offered, goodput "
            f"{rows[-1]['goodput']:.4f} ({good} of {attempts} offered "
            f"requests finished good in the run), goodput_rps "
            f"{report['goodput_rps']}, TTFT p50 {report['ttft']['p50']} s, "
            f"shed {report['shed']} of {attempts} "
            f"({rows[-1]['shed_frac']:.4f}), headroom median "
            f"{rows[-1]['median']}, floor {rows[-1]['floor']}, headroom <= "
            f"0 at sample {over}, shed > 10% at sample {shed}")
        if shed is not None and (over is None or over > shed):
            sys.exit(f"chip_smoke: at {rate:g} rps the shed fraction "
                     f"passed 10% (sample {shed}) before slo_headroom "
                     f"reached 0 (sample {over})")
        if launches:
            sys.exit(f"chip_smoke: {launches} K1-K4 launches in the sweep")
        problems = cost_ratio_problems(report)
        if problems:
            sys.exit(f"chip_smoke: chat at {rate:g} rps: {problems}")
    ok = [r["rate"] for r in rows if r["goodput"] >= 0.95]
    log(f"loadgen sweep [{CARD}]: highest rate with goodput >= 0.95: "
        f"{max(ok) if ok else 'none'} rps; phase done in "
        f"{time.perf_counter() - t0:.1f} s")
    # the headroom must tell the rates apart, not only lead the shed: a
    # signal that called overload from the start of every run would pass
    # the onset check alone. Its median must be > 0 at the lowest rate,
    # about half the engine's saturated goodput_rps, and <= 0 at every
    # rate that sheds. The highest rate with goodput >= 0.95 is not held
    # to a sign: on the H100 it is 10 requests/s, the saturated rate
    # itself, where the true headroom is about 0
    shedding = [r for r in rows if r["shed_frac"] > 0.10]
    low = rows[0]
    wrong = ([low["rate"]] if low["median"] is None or low["median"] <= 0.0
             else []) + [r["rate"] for r in shedding
                         if r["median"] is None or r["median"] > 0.0]
    if not shedding or wrong:
        sys.exit(f"chip_smoke: slo_headroom does not separate the sweep's "
                 f"rates (median > 0 at {low['rate']:g} rps; <= 0 where "
                 f"shed > 10%: {[r['rate'] for r in shedding]}; wrong at "
                 f"{wrong})")
    return rows


def phase_predictor(model, decision):
    """llama_7b saved by jit.save and run by create_predictor on the card;
    returns K1's launches over the two runs. `decision` is the router's at
    the prefill shape (phase 6): each run launches K1 once per layer,
    through the flash_fwd operator, if its forward is the kernel."""
    cfg = model.config
    shape, dtype = PREDICTOR_SPEC
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, tuple(shape))
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predictor_")
    try:
        prefix = os.path.join(tmp, "llama_7b")
        t0 = time.perf_counter()
        jit.save(model, prefix, input_spec=[jit.InputSpec(shape, dtype)])
        save_s = time.perf_counter() - t0
        nbytes = {ext: os.path.getsize(prefix + ext)
                  for ext in (".pdmodel", ".pdiparams")}
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    ops = sum(1 for n in pred._layer.program.graph.nodes
              if n.target == torch.ops.paddle_tpu_torch.flash_fwd.default)
    want = cfg.num_hidden_layers if decision.fwd == "pallas" else 0
    log(f"predictor [{CARD}]: saved in {save_s:.2f} s ({nbytes['.pdmodel']} "
        f"bytes of program, {nbytes['.pdiparams']} of params), loaded on "
        f"{pred._config._device} in {load_s:.2f} s; the program holds {ops} "
        f"flash_fwd nodes (router at the prefill shape: fwd={decision.fwd})")
    if ops != want:
        sys.exit(f"chip_smoke: the saved program holds {ops} flash_fwd "
                 f"nodes, expected {want}")
    handle = pred.get_input_handle(pred.get_input_names()[0])
    handle.copy_from_cpu(ids)
    torch.cuda.reset_peak_memory_stats()
    outs = []
    fa.flash_fwd_launches = 0                  # the main path starts here
    for _ in range(2):
        before = fa.flash_fwd_launches
        pred.run()
        outs.append(pred.get_output_handle("out0").copy_to_cpu())
        if fa.flash_fwd_launches - before != want:
            sys.exit(f"chip_smoke: a predictor run launched "
                     f"{fa.flash_fwd_launches - before} K1, expected {want}")
    launches = fa.flash_fwd_launches           # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(outs[0], outs[1]):
        sys.exit("chip_smoke: two predictor runs disagree")
    ids_dev = torch.as_tensor(ids, device="cuda")
    with torch.no_grad():
        eager = model(ids_dev).float().cpu().numpy()
    if outs[0].shape != eager.shape or not np.isfinite(outs[0]).all():
        sys.exit(f"chip_smoke: predictor logits {outs[0].shape} are not "
                 f"finite logits of {eager.shape}")
    err = float(np.abs(outs[0] - eager).max() / np.abs(eager).max())
    with torch.no_grad():
        run_ms = profile_serving.median_ms(pred.run, lambda: None)
        eager_ms = profile_serving.median_ms(
            lambda: model(ids_dev).float().cpu(), lambda: None)
    log(f"predictor [{CARD}]: logits against the eager forward: max err / "
        f"max|logit| {err:.3e} (tol {PREDICTOR_LOGITS_RTOL}), runs equal; "
        f"K1 launches {launches} over 2 runs; run {run_ms:.3f} ms, eager "
        f"forward {eager_ms:.3f} ms (CUDA events, median of 5, each with "
        f"the logits' copy to the host); peak memory {peak / 2**30:.2f} GiB")
    if not err <= PREDICTOR_LOGITS_RTOL:
        sys.exit("chip_smoke: predictor logits disagree with the eager "
                 "forward")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
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
    model = build_llama_7b()
    serve = phase_slice(decisions["prefill"][0], model)
    plain9, bf16_logits = phase_engine(model)
    phase_knobs(model, plain9, bf16_logits)
    phase_loadgen(model)
    predictor = phase_predictor(model, decisions["prefill"][0])
    del model
    epilogue = phase_epilogue(decisions)
    train = phase_train(decisions["train"][0])
    src = "paddle_tpu_torch/csrc/flash_attention_"
    ref = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K1 runs on the serving, predictor and training paths; its times are
    # the training shape's. K2's are
    # the serving prefill shape's (no single library call computes it).
    # "ms" and "library_ms" are device times from back-to-back calls
    kernels = [dict(name="flash_fwd", route="cuda", source=src + "fwd.cu",
                    replaces=ref + "116",
                    launches=serve + predictor + train["flash_fwd"],
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

"""Per-shape attention backend router.

reference: paddle_tpu/ops/pallas/attention_router.py. One decision per
shape key (batch*heads, seq_q, seq_k, head_dim, dtype, causal): the flash
kernels ('pallas', the name the reference's ledger format uses for them)
or the dense torch path ('xla'), for the forward and the backward apart.
fwd=pallas with bwd=xla is the hybrid: the K1 forward, then the dense
rematerialised backward.

Sources, in priority order, every decision carrying its provenance:

1. **The ledger**: `attention_ledger.json` next to this module (or
   `FLAGS_attention_ledger_path`), baked by
   `paddle_tpu_torch/tools/bake_attention_ledger.py` from the card's
   timings (`paddle_tpu_torch/tools/flash_vs_xla.py`). End-to-end entries
   (an exact batch*heads match, measured as a whole training step) outrank
   isolated-kernel entries. Entries of another device kind are ignored; a
   ledger of another format is not read at all (fails open).
2. **Measurement**: on a ledger miss on a CUDA device, `_measure_cuda`
   times the kernels against the dense path on the live card. It does not
   catch a failure: a kernel that does not build or launch raises here,
   rather than the router routing around it. Off CUDA, a deterministic
   roofline proxy (a hypothesis, not a measurement, and labelled so).
3. **Heuristic**: the reference's legacy thresholds, verbatim, when the
   mode flag forbids measuring.

`nn.functional.scaled_dot_product_attention`, the flash backward,
`incubate`'s fused epilogue and generation's prefill consult this module.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Any, Optional

import torch

from ..framework import flags as _flags

__all__ = ["Decision", "route", "load_ledger", "ledger_blocks",
           "epilogue_fusion_wins", "packed_grid_enabled", "decision_log",
           "clear_routing_cache", "median_ms", "LEDGER_FORMAT"]

LEDGER_FORMAT = 1

_DEFAULT_LEDGER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "attention_ledger.json")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One routed choice for an attention shape.

    fwd/bwd: 'pallas' (the flash kernels) or 'xla' (dense torch).
    blocks_* are tilings when the ledger recorded them (the port's kernels
    have fixed 64x64 tiles, so its ledger records none). packed_grid is
    always False: the port's kernels stop at the causal bound instead of
    packing the grid. source is machine-readable ('ledger-e2e' | 'ledger' |
    'measured-cuda' | 'proxy' | 'heuristic'); provenance is the audit
    string."""

    fwd: str
    bwd: str
    blocks_fwd: Optional[tuple] = None
    blocks_bwd: Optional[tuple] = None
    packed_grid: bool = False
    source: str = "heuristic"
    provenance: str = ""


# --------------------------------------------------------------------------
# ledger loading
# --------------------------------------------------------------------------

_ledger_cache: dict[str, Any] = {}
_route_cache: dict[Any, Decision] = {}
_decision_log: list[tuple] = []


def _ledger_path() -> str:
    return _flags.flag_value("attention_ledger_path") or _DEFAULT_LEDGER


def load_ledger(path: Optional[str] = None):
    """Parse (and cache) the ledger; None when absent, unreadable, or of a
    format this code does not understand (a stale table fails OPEN to the
    measurement/heuristic path, never silently misroutes)."""
    path = path or _ledger_path()
    if path in _ledger_cache:
        return _ledger_cache[path]
    doc = None
    try:
        with open(path) as f:
            parsed = json.load(f)
        if isinstance(parsed, dict) and \
                parsed.get("ledger_format") == LEDGER_FORMAT:
            doc = parsed
    except (OSError, ValueError):
        doc = None
    _ledger_cache[path] = doc
    return doc


def clear_routing_cache():
    """Drop cached ledgers and decisions (tests; after re-baking)."""
    _ledger_cache.clear()
    _route_cache.clear()
    _decision_log.clear()


def decision_log():
    """[(key, Decision)] for every distinct shape routed this process."""
    return list(_decision_log)


def _norm_dtype(dtype) -> str:
    s = str(dtype)
    return s.split(".")[-1].replace("'>", "").replace("<class ", "")


def _cuda_name() -> Optional[str]:
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else None


def _device_kind(platform: Optional[str]) -> str:
    if platform is None or platform == "cuda":
        name = _cuda_name()
        if name is not None:
            return name
    return platform or "cpu"


def _match_entries(ledger, bh, sq, sk, d, dtype, causal, device_kind):
    """-> (e2e_entry, isolated_entry) matching this shape (either None).

    End-to-end entries need an exact (seq, head_dim, bh) match: they
    describe one measured training config. Isolated entries match on
    (seq, head_dim, causal, dtype) with the nearest recorded batch*heads."""
    if ledger is None or sq != sk:
        return None, None
    if ledger.get("device_kind") and ledger["device_kind"] != device_kind:
        return None, None

    def _ok(e):
        return (e.get("seq") == sq and e.get("head_dim") == d
                and bool(e.get("causal", True)) == bool(causal)
                and e.get("dtype", "bfloat16") == dtype)

    e2e = None
    for e in ledger.get("end_to_end", []):
        if _ok(e) and e.get("bh") == bh:
            e2e = e
            break
    isolated = None
    best_gap = None
    for e in ledger.get("entries", []):
        if not _ok(e):
            continue
        gap = abs((e.get("bh") or 0) - bh)
        if best_gap is None or gap < best_gap:
            isolated, best_gap = e, gap
    return e2e, isolated


def ledger_blocks(kind: str, bh: int, sq: int, sk: int, d: int, dtype,
                  causal: bool, device_kind: Optional[str] = None):
    """(block_q, block_k) the ledger recorded for this shape, or None."""
    dk = device_kind or _device_kind(None)
    _, iso = _match_entries(load_ledger(), bh, sq, sk, d,
                            _norm_dtype(dtype), causal, dk)
    if iso is None:
        return None
    blocks = iso.get("blocks_fwd" if kind == "fwd" else "blocks_bwd")
    if blocks and blocks[0] <= sq and blocks[1] <= sk:
        return tuple(blocks)
    return None


def epilogue_fusion_wins(bh: int, sq: int, sk: int, d: int, dtype,
                         causal: bool = True,
                         device_kind: Optional[str] = None) -> bool:
    """Whether the ledger marks the fused RMSNorm+residual flash epilogue
    (K2) a winner at this shape (entry field `fused_epilogue_wins`, K2
    against K1 followed by the torch epilogue). False on any miss: the
    fusion is taken only at shapes where the card measured it winning."""
    dk = device_kind or _device_kind(None)
    _, iso = _match_entries(load_ledger(), bh, sq, sk, d,
                            _norm_dtype(dtype), causal, dk)
    return bool(iso and iso.get("fused_epilogue_wins"))


def packed_grid_enabled(platform: Optional[str] = None) -> bool:
    """False: the reference packs the causal lower triangle into its TPU
    grid; the port's kernels run one block per q tile and stop their key
    loop at the causal bound, which skips the same masked tiles."""
    return False


# --------------------------------------------------------------------------
# measurement fallback
# --------------------------------------------------------------------------

# deterministic roofline constants for the off-CUDA proxy: the H100 SXM's
# published dense bf16 peak and HBM rate (NVIDIA data sheet). eff_* are
# tensor-core utilization fractions kept from the reference (pinned there
# to a TPU measurement; dense and flash assumed equal) — HYPOTHESES for
# this card, never measured on it, and labelled so in every decision.
_PROXY = {"peak_flops": 989e12, "eff_dense": 0.068, "eff_flash": 0.068,
          "hbm_bps": 3.35e12}


def _proxy_ms(kind, bh, sq, sk, d, dtype, causal, backend) -> float:
    """Analytic max(compute, memory) time in ms. Deterministic: pure
    arithmetic on the shape key, no clocks, no randomness. The kernels'
    causal loop bound halves their causal work (the reference's packed
    grid does the same)."""
    nbytes = 2 if dtype in ("bfloat16", "float16") else 4
    fwd_flops = 4.0 * bh * sq * sk * d            # QK^T + PV
    io = bh * (sq + 2 * sk) * d * nbytes + bh * sq * d * nbytes
    if kind == "bwd":
        fwd_flops *= 2.5                          # dS, dQ, dK, dV dots
        io *= 2.0
    if backend == "pallas":
        flops = fwd_flops * (0.5 if causal else 1.0)
        t = max(flops / (_PROXY["peak_flops"] * _PROXY["eff_flash"]),
                io / _PROXY["hbm_bps"])
    else:
        # dense materializes the (sq, sk) f32 scores at least once
        # (write + read through softmax); the remat backward pays it
        # again on the recompute
        s2 = bh * sq * sk * 4.0 * (3.0 if kind == "bwd" else 2.0)
        t = max(fwd_flops / (_PROXY["peak_flops"] * _PROXY["eff_dense"]),
                (io + s2) / _PROXY["hbm_bps"])
    return t * 1e3


def median_ms(fn, reps=5, warmup=1):
    """Median ms of `reps` single calls of `fn` on CUDA events, after
    `warmup` calls (the first also builds the kernels)."""
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


def _measure_cuda(bh, sq, sk, d, dtype, causal):
    """Flash against dense on the live card: the forward (K1 against the
    dense forward) and the backward (K3 and K4 against the dense
    rematerialised backward, which recomputes the forward), timed on CUDA
    events at batch*heads min(bh, 64), median of 5 after a warm-up.
    Returns {(kind, backend): ms}. Nothing is caught: a kernel that fails
    to build or launch raises. The kernel launches made here count on the
    kernels' launch counters."""
    from . import flash_attention as fa
    tb = min(bh, 64)
    dp = fa._padded_dim(d)
    scale = 1.0 / d ** 0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(s):
        return torch.randn(tb, s, d, generator=gen, device="cuda").to(
            getattr(torch, dtype))

    # own saved-tensor hooks (identity), so a measurement made inside a
    # checkpointed forward does not hand its tensors to the checkpoint;
    # out of inference mode, so the dense backward can run autograd
    with torch.inference_mode(False), \
            torch.autograd.graph.saved_tensors_hooks(lambda x: x,
                                                     lambda x: x):
        q, k, v, g = rand(sq), rand(sk), rand(sk), rand(sq)
        pad = torch.nn.functional.pad
        qp, kp, vp, gp = (pad(x, (0, dp - d)).contiguous()
                          for x in (q, k, v, g))
        with torch.no_grad():
            o, lse = fa._flash_fwd_bhsd(qp, kp, vp, causal, scale)
            out = {
                ("fwd", "pallas"): median_ms(
                    lambda: fa._flash_fwd_bhsd(qp, kp, vp, causal, scale)),
                ("fwd", "xla"): median_ms(
                    lambda: fa._xla_attention_bhsd(q, k, v, causal, scale)),
                ("bwd", "pallas"): median_ms(
                    lambda: fa._flash_bwd_bhsd(qp, kp, vp, o, lse, gp,
                                               causal, scale)),
            }
        out[("bwd", "xla")] = median_ms(
            lambda: fa._dense_remat_bwd(q, k, v, causal, scale, 1, g))
    return out


def _heuristic(bh, sq, sk, d) -> str:
    """The legacy _use_pallas thresholds (calibrated to the r4/r5
    f32-operand kernels; kept only as the last-resort fallback)."""
    if d % 128 == 0:
        return "pallas" if sq >= 1024 else "xla"
    return "pallas" if (d >= 96 and sq >= 2048) else "xla"


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------

def route(batch_heads: int, seq_q: int, seq_k: int, head_dim: int, dtype,
          causal: bool, platform: Optional[str] = None,
          device_kind: Optional[str] = None) -> Decision:
    """Resolve the attention backend for one shape key.

    batch_heads = batch * num_query_heads. platform ('cuda' or 'cpu') and
    device_kind default to the live CUDA device, else the CPU; tests pass
    them to route for a device they are not running on. A device kind other
    than the live card's routes as the CPU does (it is never measured).
    Decisions are cached per (key, ledger path, mode flag)."""
    dtype = _norm_dtype(dtype)
    mode = _flags.flag_value("attention_router")
    dk = device_kind or _device_kind(platform)
    plat = platform or ("cuda" if dk == _cuda_name() else "cpu")
    key = (batch_heads, seq_q, seq_k, head_dim, dtype, bool(causal),
           plat, dk, _ledger_path(), mode)
    hit = _route_cache.get(key)
    if hit is not None:
        return hit

    packed = packed_grid_enabled(plat)
    dec = None

    if mode != "heuristic":
        led = load_ledger()
        e2e, iso = _match_entries(led, batch_heads, seq_q, seq_k, head_dim,
                                  dtype, causal, dk)
        if e2e is not None:
            dec = Decision(
                fwd=e2e.get("fwd", "pallas"), bwd=e2e.get("bwd", "pallas"),
                blocks_fwd=tuple(iso["blocks_fwd"]) if iso and
                iso.get("blocks_fwd") else None,
                blocks_bwd=tuple(iso["blocks_bwd"]) if iso and
                iso.get("blocks_bwd") else None,
                packed_grid=packed, source="ledger-e2e",
                provenance=(
                    f"ledger v{led.get('version')} r{led.get('round')} "
                    f"end-to-end [{e2e.get('config')}] on "
                    f"{led.get('device_kind')}: fwd={e2e.get('fwd')} "
                    f"bwd={e2e.get('bwd')} ({e2e.get('note', 'measured')})"))
        elif iso is not None:
            dec = Decision(
                fwd=iso.get("fwd", "pallas"), bwd=iso.get("bwd", "pallas"),
                blocks_fwd=tuple(iso["blocks_fwd"]) if
                iso.get("blocks_fwd") else None,
                blocks_bwd=tuple(iso["blocks_bwd"]) if
                iso.get("blocks_bwd") else None,
                packed_grid=packed, source="ledger",
                provenance=(
                    f"ledger v{led.get('version')} r{led.get('round')} "
                    f"measured on {led.get('device_kind')} at bh="
                    f"{iso.get('bh')}: fwd={iso.get('fwd')} "
                    f"({json.dumps(iso.get('fwd_ms', {}))}) "
                    f"bwd={iso.get('bwd')} "
                    f"({json.dumps(iso.get('bwd_ms', {}))})"))

    if dec is None and mode == "auto":
        if plat == "cuda":
            ms = _measure_cuda(batch_heads, seq_q, seq_k, head_dim, dtype,
                               causal)
            fwd = min(("pallas", "xla"), key=lambda b: ms[("fwd", b)])
            bwd = min(("pallas", "xla"), key=lambda b: ms[("bwd", b)])
            dec = Decision(
                fwd=fwd, bwd=bwd, packed_grid=packed, source="measured-cuda",
                provenance=("measured live on "
                            f"{dk} (ledger miss): "
                            + json.dumps({f"{k[0]}_{k[1]}": round(v, 3)
                                          for k, v in ms.items()})))
        else:
            est = {(k, b): _proxy_ms(k, batch_heads, seq_q, seq_k,
                                     head_dim, dtype, causal, b)
                   for k in ("fwd", "bwd") for b in ("pallas", "xla")}
            fwd = min(("pallas", "xla"), key=lambda b: est[("fwd", b)])
            bwd = min(("pallas", "xla"), key=lambda b: est[("bwd", b)])
            dec = Decision(
                fwd=fwd, bwd=bwd, packed_grid=packed, source="proxy",
                provenance=("analytic roofline proxy (no CUDA device "
                            "measured; NOT a measurement — assumes the "
                            "kernels reach the dense path's tensor-core "
                            "efficiency): "
                            + json.dumps({f"{k[0]}_{k[1]}": round(v, 3)
                                          for k, v in est.items()})))

    if dec is None:
        b = _heuristic(batch_heads, seq_q, seq_k, head_dim)
        dec = Decision(fwd=b, bwd="pallas", packed_grid=packed,
                       source="heuristic",
                       provenance=("legacy seq/head_dim thresholds "
                                   "(calibrated to the retired f32-operand "
                                   "TPU kernels; no ledger entry, "
                                   "measurement not allowed)"))

    _route_cache[key] = dec
    _decision_log.append((key[:6], dec))
    del _decision_log[:-256]  # bound the audit log
    try:
        # every fresh decision (cache hits excluded) counted by source, as
        # the reference counts it (:450-458)
        from ..observability.catalog import metric as _obs_metric
        _obs_metric("attention_router_decisions_total",
                    source=dec.source).inc()
    except Exception:  # noqa: BLE001 - routing never fails on telemetry
        pass
    return dec

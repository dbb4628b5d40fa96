"""Bake the card's attention timings into the router's ledger. reference:
the `--ledger` mode of tools/bake_flash_blocks.py (:115-203).

    python3 -m paddle_tpu_torch.tools.bake_attention_ledger \\
        [flash_vs_xla.json] [--out PATH] [--round N]

Reads the JSON that `paddle_tpu_torch/tools/flash_vs_xla.py` wrote on the
card and writes the ledger `paddle_tpu_torch/ops/attention_router.py`
reads (default: paddle_tpu_torch/ops/attention_ledger.json), in the
reference's format (`ledger_format` 1):
- one isolated entry per measured shape: the forward winner (flash K1
  against the dense forward), the backward winner given a flash forward
  (K3/K4 against the dense rematerialised backward: both totals share the
  flash forward, so the totals order the backwards), the ms of both
  backends for each, and `fused_epilogue_wins` (K2 against K1 followed by
  the torch epilogue) with both ms;
- one end-to-end entry per training config measured under both backward
  modes: the faster step's backward, with each mode's MFU and step time.
The device kind and the card's power limit come from the measured file.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["bake_ledger"]

_DEFAULT_IN = "flash_vs_xla.json"
_DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "attention_ledger.json")


def bake_ledger(doc, source="flash_vs_xla.json", round_num=1):
    """-> the ledger dict for attention_router.py from a flash_vs_xla
    document (the caller writes it)."""
    dtype = doc.get("dtype", "bfloat16")
    causal = bool(doc.get("causal", True))
    entries = []
    for row in doc.get("rows", []):
        fwd_ms = {"pallas": row["flash_fwd_ms"], "xla": row["dense_fwd_ms"]}
        bwd_ms = {"pallas": row["fwdbwd_ms_pallas"],
                  "xla": row["fwdbwd_ms_hybrid"]}
        epi_ms = {"fused": row["fused_epilogue_ms"],
                  "unfused": row["unfused_epilogue_ms"]}
        entries.append({
            "seq": row["seq"], "head_dim": row["head_dim"],
            "bh": row["batch"] * row["heads"], "causal": causal,
            "dtype": dtype,
            "fwd": min(fwd_ms, key=fwd_ms.get),
            "bwd": min(bwd_ms, key=bwd_ms.get),
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "fwdbwd_ms_dense": row.get("fwdbwd_ms_dense"),
            "fused_epilogue_wins": epi_ms["fused"] < epi_ms["unfused"],
            "epilogue_ms": epi_ms,
            "max_abs_err": row.get("max_abs_err"),
            "epilogue_max_abs_err": row.get("epilogue_max_abs_err"),
        })
    by_cfg = {}
    for row in doc.get("end_to_end", []):
        by_cfg.setdefault((row["config"], row["batch"], row["seq"]),
                          []).append(row)
    e2e = []
    for (cfg, batch, seq), rows in sorted(by_cfg.items()):
        modes = {r["bwd"] for r in rows}
        if modes != {"pallas", "xla"}:
            continue    # only a real A/B ships
        best = min(rows, key=lambda r: r["step_time_s"])
        e2e.append({
            "config": cfg, "seq": seq, "head_dim": best["head_dim"],
            "bh": batch * best["heads"], "causal": True, "dtype": dtype,
            "fwd": best["fwd"], "bwd": best["bwd"],
            "mfu": {r["bwd"]: r["mfu"] for r in rows},
            "step_ms": {r["bwd"]: r["step_time_s"] * 1e3 for r in rows},
            "steps": best["steps"],
            "note": ("end-to-end training-step A/B through "
                     "tools/train_llama.run_one, flash forward, "
                     f"backward pallas vs xla, {best['steps']} timed steps "
                     "each"),
        })
    return {
        "ledger_format": 1,
        "version": 1,
        "round": round_num,
        "device_kind": doc.get("device_kind"),
        "nvidia_smi": doc.get("nvidia_smi"),
        "dtype": dtype,
        "generated_from": [source],
        "kernel_note": ("fwd: K1 (flash_attention_bshd) vs the dense "
                        "forward; bwd: flash forward + K3/K4 vs flash "
                        "forward + dense rematerialised backward; epilogue: "
                        "K2 vs K1 + torch epilogue; medians of "
                        f"{doc.get('reps')} calls on CUDA events, torch "
                        f"{doc.get('torch')}, CUDA {doc.get('cuda')}"),
        "packed_grid_validated": False,
        "entries": entries,
        "end_to_end": e2e,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=_DEFAULT_IN)
    ap.add_argument("--out", default=_DEFAULT_OUT)
    ap.add_argument("--round", type=int, default=1)
    args = ap.parse_args()
    with open(args.path) as f:
        doc = json.load(f)
    led = bake_ledger(doc, os.path.basename(args.path), args.round)
    with open(args.out, "w") as f:
        json.dump(led, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: {len(led['entries'])} measured entries, "
          f"{len(led['end_to_end'])} end-to-end entries (device "
          f"{led['device_kind']}, {led['nvidia_smi']})")


if __name__ == "__main__":
    main()

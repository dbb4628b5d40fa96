#!/usr/bin/env python
"""IR dump and pass-pipeline inspector for the PIR-lite compiler layer.

reference: tools/ir_dump.py.

Usage:
  python3 -m paddle_tpu_torch.tools.ir_dump --example llama_block
  python3 -m paddle_tpu_torch.tools.ir_dump --example mlp --diff
  python3 -m paddle_tpu_torch.tools.ir_dump --example sdpa_epilogue --check
  python3 -m paddle_tpu_torch.tools.ir_dump --all --check --device cpu

Examples are named, fixed-seed programs: a llama decoder block, an MLP and
the unfused attention + RMSNorm epilogue (incubate's
fused_attention_rms_epilogue off the card, which the patterns turn into
`pt.sdpa_rms_epilogue`). Each is captured, then every enabled pass runs in
turn and the tool prints its edits and the op count before and after
(with --diff the whole IR as a unified diff). `--check` runs the verifier
after capture and after every pass (strict dead-code after dce), replays
the program after every pass that changed it against the eager function on
the same inputs, and exits non-zero if any pass changed numerics (beyond
TOL) or produced IR the verifier rejects. The examples run on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import difflib
import sys

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import pir

TOL = dict(rtol=2e-5, atol=2e-6)


def _layer_flat(layer, *inputs):
    """(flat_fn, flat_args): the layer over its parameters as program
    inputs, the way jit.to_static closes over them."""
    names = [k for k, _ in layer.named_parameters()]
    params = [p.detach() for _, p in layer.named_parameters()]

    def flat_fn(*leaves):
        state = dict(zip(names, leaves[:len(names)]))
        return (torch.func.functional_call(layer, state,
                                           tuple(leaves[len(names):])),)

    return flat_fn, params + list(inputs)


def ex_mlp(device):
    from paddle_tpu_torch import nn
    paddle.seed(0)
    model = nn.Sequential(nn.Linear(8, 16, device=device), nn.ReLU(),
                          nn.Linear(16, 4, device=device))
    x = torch.tensor(np.random.RandomState(0).randn(4, 8), dtype=torch.float32,
                     device=device)
    return _layer_flat(model, x)


def ex_llama_block(device):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaDecoderLayer
    cfg = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=4,
                      num_key_value_heads=2, dtype="float32")
    paddle.seed(0)
    layer = LlamaDecoderLayer(cfg, device=device).eval()
    x = torch.tensor(np.random.RandomState(0).randn(1, 16, 32),
                     dtype=torch.float32, device=device)
    return _layer_flat(layer, x)


def ex_sdpa_epilogue(device):
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_attention_rms_epilogue
    from paddle_tpu_torch.incubate.nn import functional as inc
    rng = np.random.RandomState(0)
    b, s, h, d = 1, 16, 4, 8
    q, k, v, res = (torch.tensor(rng.randn(b, s, h, d), dtype=torch.float32,
                                 device=device) for _ in range(4))
    w = torch.tensor(rng.rand(d), dtype=torch.float32, device=device)

    def fn(q_, k_, v_, r_, w_):
        if q_.device.type == "cuda":
            # the unfused composition incubate takes off the card
            kx, vx = inc._expand_gqa(k_, v_, h)
            return (inc._rms_epilogue(inc._sdpa_dense(q_, kx, vx, True),
                                      r_, w_, 1e-6),)
        return (fused_attention_rms_epilogue(q_, k_, v_, r_, w_),)

    return fn, [q, k, v, res, w]


EXAMPLES = {
    "mlp": ex_mlp,
    "llama_block": ex_llama_block,
    "sdpa_epilogue": ex_sdpa_epilogue,
}


def _verify(prog, name, where, strict_dead=False):
    try:
        pir.verify_program(prog, strict_dead=strict_dead, where=where)
        return True
    except pir.IRVerificationError as e:
        print(f"  !! verifier rejected {name} after {where}: {e}")
        return False


def _print_diff(before, after):
    for line in difflib.unified_diff(before.splitlines(),
                                     after.splitlines(), lineterm="", n=1):
        print("    " + line)


def run_example(name, device, diff=False, check=False):
    """Returns True when --check passed (or was not asked for)."""
    fn, flat = EXAMPLES[name](device)
    with torch.no_grad():
        eager = [o.detach().double().cpu().numpy() for o in fn(*flat)]
    prog, _ = pir.capture(fn, *flat, name=name)
    print(f"== {name}: captured {prog.num_ops()} ops "
          f"(hash {prog.canonical_hash()[:16]})")
    if diff:
        print(prog.to_string())
    ok = _verify(prog, name, "capture") if check else True
    for p in pir.PassManager.default().passes:
        before_ops = prog.num_ops()
        before_txt = prog.to_string() if diff else None
        result = p.run(prog)
        print(f"  pass {p.name:8s} edits={result.edits:<4d} "
              f"ops {before_ops} -> {prog.num_ops()}  [{result.notes}]")
        if diff and result.changed:
            _print_diff(before_txt, prog.to_string())
        if check:
            ok &= _verify(prog, name, p.name, strict_dead=(p.name == "dce"))
        if check and result.changed:
            with torch.no_grad():
                got = [o.detach().double().cpu().numpy()
                       for o in prog.bind(*flat)]
            for e, g in zip(eager, got):
                if not np.allclose(e, g, **TOL):
                    drift = float(np.max(np.abs(e - g)))
                    print(f"  !! pass {p.name} changed numerics for {name}: "
                          f"max drift {drift:.3e}")
                    ok = False
    pt_ops = [op.name for op in prog.ops if op.name.startswith("pt.")]
    if pt_ops:
        print(f"  pt ops: {pt_ops}")
    for op in prog.ops:
        fg = op.attrs.get("fusion_group")
        if fg:
            print(f"  fusion group g{fg['id']}: kind={fg['kind']} "
                  f"outs={fg['outs']} {len(fg['ops'])} ops "
                  f"predicted_bytes_saved={fg['predicted_bytes_saved']}")
    if check and ok:
        print("  check OK: every pass verifies and matches eager on the "
              "fixed seed")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--example", choices=sorted(EXAMPLES))
    ap.add_argument("--all", action="store_true", help="every example")
    ap.add_argument("--diff", action="store_true",
                    help="print the IR before/after each changing pass")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if a pass changes numerics or "
                         "produces IR the verifier rejects")
    ap.add_argument("--device", default="cuda",
                    help="where the examples run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = sorted(EXAMPLES) if args.all or not args.example \
        else [args.example]
    ok = True
    for n in names:
        ok &= run_example(n, args.device, diff=args.diff, check=args.check)
    if args.check and not ok:
        print("IR CHECK FAILED: a pass changed numerics or produced IR the "
              "verifier rejects")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

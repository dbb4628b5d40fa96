"""The compile cache's artifact: a rewritten pir.Program as bytes, without
pickle.

reference: the reference stores a serialized `jax.export.Exported`
(StableHLO) of the post-pass program (paddle_tpu/pir/cache.py,
pipeline.py). The port has no backend compiler between the program and the
card, so its artifact is the rewritten program itself:

  payload = u32 header length + header JSON + constant bytes

The header lists the program's values (shape, dtype, device and, where
the sharding passes annotated it, the sharding spec), its ops (with their
attributes, the `sharding_rule` stamps among them) and its outputs; a
loaded program carries the annotations the compiled one had, as the
reference's XLA artifact has its sharding baked in. A captured op is stored as its OpOverload's qualified name
("aten.mm.default", "paddle_tpu_torch.flash_fwd.default": the registered
K1/K2 operators resolve through torch.ops like any aten op) with its
argument template, encoded as tagged JSON (dtypes, devices, layouts and
memory formats by name). A `pt.sdpa`, `pt.sdpa_rms_epilogue` or
`pt.fused_region` op is stored as its name, its attributes and its region,
a nested program of the ops it replays, and is rebuilt with the same
callable the pass gave it. Constants are raw bytes after the header.
Anything else (a Python object in an argument, say) makes the program
unserializable: `dumps` raises TypeError and the pipeline writes no
artifact.
"""

from __future__ import annotations

import json
import math
import struct

import torch

from .ir import Operation, Program, Ref, dtype_name

__all__ = ["dumps", "loads"]


def _enc(a):
    if isinstance(a, Ref):
        return {"$ref": a.i}
    if a is None or isinstance(a, (bool, int, str)):
        return a
    if isinstance(a, float):
        return a if math.isfinite(a) else {"$float": repr(a)}
    if isinstance(a, tuple):
        return {"$tuple": [_enc(x) for x in a]}
    if isinstance(a, list):
        return [_enc(x) for x in a]
    if isinstance(a, dict):
        return {"$dict": {str(k): _enc(v) for k, v in a.items()}}
    if isinstance(a, torch.dtype):
        return {"$dtype": dtype_name(a)}
    if isinstance(a, torch.device):
        return {"$device": str(a)}
    if isinstance(a, torch.layout):
        return {"$layout": str(a).removeprefix("torch.")}
    if isinstance(a, torch.memory_format):
        return {"$memory_format": str(a).removeprefix("torch.")}
    raise TypeError(f"cannot serialize argument {type(a).__name__}")


def _dec(a):
    if isinstance(a, list):
        return [_dec(x) for x in a]
    if not isinstance(a, dict):
        return a
    (tag, v), = a.items()
    if tag == "$ref":
        return Ref(v)
    if tag == "$float":
        return float(v)
    if tag == "$tuple":
        return tuple(_dec(x) for x in v)
    if tag == "$dict":
        return {k: _dec(x) for k, x in v.items()}
    if tag == "$dtype":
        return getattr(torch, v)
    if tag == "$device":
        return torch.device(v)
    if tag in ("$layout", "$memory_format"):
        return getattr(torch, v)
    raise ValueError(f"unknown tag {tag!r}")


def _target(qualname):
    ns, name, overload = qualname.split(".")
    if ns == "paddle_tpu_torch":
        from ..ops import flash_attention  # noqa: F401 — registers K1/K2
    return getattr(getattr(getattr(torch.ops, ns), name), overload)


class _Writer:
    def __init__(self):
        self.blobs: list[bytes] = []
        self.offset = 0
        self.ids: dict[int, int] = {}

    def vid(self, v):
        return self.ids.setdefault(id(v), len(self.ids))

    def value(self, v):
        rec = {"id": self.vid(v), "shape": list(v.shape),
               "dtype": dtype_name(v.dtype),
               "device": None if v.device is None else str(v.device)}
        if v.sharding is not None:
            rec["sharding"] = list(v.sharding)
        return rec

    def const(self, v, t):
        raw = t.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes()
        rec = dict(self.value(v), offset=self.offset, nbytes=len(raw))
        self.blobs.append(raw)
        self.offset += len(raw)
        return rec

    def program(self, inputs, ops, outputs, constants):
        return {"inputs": [self.value(v) for v in inputs],
                "constants": [self.const(v, c) for v, c in constants],
                "ops": [self.op(op) for op in ops],
                "outputs": [self.vid(v) for v in outputs]}

    def op(self, op):
        rec = {"name": op.name, "in": [self.vid(v) for v in op.inputs],
               "out": [self.value(v) for v in op.outputs]}
        if op.target is not None:
            rec.update(target=str(op.target), spec=_enc(op.spec),
                       multi=op.multi, attrs=_enc(op.attrs))
            return rec
        body = getattr(op.fn, "body", None)
        if body is None:
            raise TypeError(f"cannot serialize {op.name}: no region")
        boundary, members, outs, consts = body
        attrs = {k: v for k, v in op.attrs.items()}
        rec.update(attrs=_enc(attrs),
                   region=self.program(boundary, members, outs,
                                       list(consts.items())))
        return rec


def dumps(prog: Program) -> bytes:
    w = _Writer()
    doc = {"name": prog.name,
           "program": w.program(prog.inputs, prog.ops, prog.outputs,
                                list(prog.constants.items()))}
    head = json.dumps(doc).encode()
    return struct.pack("<I", len(head)) + head + b"".join(w.blobs)


class _Reader:
    def __init__(self, blob, start):
        self.blob = blob
        self.start = start
        self.values: dict[int, object] = {}

    def value(self, prog, rec):
        v = prog.new_value(rec["shape"], getattr(torch, rec["dtype"]),
                           device=rec["device"])
        if rec.get("sharding") is not None:
            v.sharding = tuple(rec["sharding"])
        self.values[rec["id"]] = v
        return v

    def program(self, rec, name):
        prog = Program(name)
        prog.inputs = [self.value(prog, r) for r in rec["inputs"]]
        for r in rec["constants"]:
            v = self.value(prog, r)
            lo = self.start + r["offset"]
            raw = bytearray(self.blob[lo:lo + r["nbytes"]])
            t = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
                torch.empty(0, dtype=torch.uint8)
            t = t.view(v.dtype).reshape(v.shape)
            prog.constants[v] = t.to(v.device) if v.device else t
        for r in rec["ops"]:
            prog.ops.append(self.op(prog, r))
        prog.outputs = [self.values[i] for i in rec["outputs"]]
        return prog

    def op(self, prog, rec):
        ins = [self.values[i] for i in rec["in"]]
        outs = [self.value(prog, r) for r in rec["out"]]
        attrs = _dec(rec["attrs"])
        if "target" in rec:
            return Operation(rec["name"], ins, outs, attrs=attrs,
                             eqn=(_target(rec["target"]), _dec(rec["spec"])),
                             multi=rec["multi"])
        saved = dict(self.values)     # the region's values stay its own
        sub = self.program(rec["region"], rec["name"])
        self.values = saved
        return Operation(rec["name"], ins, outs, attrs=attrs,
                         fn=_pt_fn(rec["name"], attrs, sub))


def _pt_fn(name, attrs, sub):
    """The callable a pass gives a pt op, rebuilt over its region."""
    from .patterns import make_epilogue_fn, make_sdpa_fn

    def replay(*args):
        out = sub.bind(*args)
        return out if name == "pt.fused_region" else out[0]

    replay.body = (sub.inputs, sub.ops, sub.outputs, sub.constants)
    if name == "pt.sdpa":
        fn = make_sdpa_fn(attrs, replay)
    elif name == "pt.sdpa_rms_epilogue":
        fn = make_epilogue_fn(attrs, replay)
    elif name == "pt.fused_region":
        fn = replay
    else:
        raise ValueError(f"unknown pt op {name!r}")
    fn.body = replay.body
    return fn


def loads(payload: bytes, name: str = "program") -> Program:
    (hlen,) = struct.unpack("<I", payload[:4])
    doc = json.loads(payload[4:4 + hlen].decode())
    return _Reader(payload, 4 + hlen).program(doc["program"],
                                              doc.get("name", name))

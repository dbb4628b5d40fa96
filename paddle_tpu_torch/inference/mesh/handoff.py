"""Serialized paged-KV handoff between disaggregated serving workers.

A prefill worker's `engine.export_kv` record — the prompt's KV blocks in
the pool's RAW storage representation (payload + scales when quantized)
plus the stream's identity (trace id, sampling seed, arrival anchors) —
is packed into one self-describing wire buffer, transferred, and
installed on a decode worker through `engine.import_kv`. Because the
payload is the stored bytes (never dequantized values), the round trip
is byte-exact for every KVBlockFormat: native/bf16 passthrough and
int8/fp8 quantized alike, so the decode side continues the stream
byte-identically to a single-process engine.

Failure contract (`mesh.kv_handoff` fault site): transient transfer
failures retry under the caller's RetryPolicy; exhaustion raises
KVHandoffError and the router falls back to RE-PREFILLING the request
on the decode side — slower, never wrong (greedy decode is
deterministic and sampled lanes draw from (seed, absolute position), so
the re-prefilled stream is the same stream).

Wire format (version 1): little-endian u32 header length, a sorted-key
JSON header (scalar metadata + per-array dtype/shape manifest), then the
arrays' raw bytes concatenated in sorted key order. Deterministic — the
same record packs to the same bytes.

Port: reference paddle_tpu/inference/mesh/handoff.py, with the same wire
format. A record's arrays are numpy arrays or CPU torch tensors; the
manifest names each dtype as numpy prints it ("float32", "int8",
"bfloat16", "float8_e4m3fn", "float8_e5m2"). numpy has no bfloat16 or
float8 type, so those travel as the bytes of an integer view of the same
width, and `unpack_record` maps the name back to the torch dtype. Arrays
unpack as CPU torch tensors, the prompt as an int32 numpy array, as the
reference's; a record packed by either package unpacks in the other with
the same bytes.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ...resilience.faults import FaultInjected, fault_point

__all__ = ["KVHandoffError", "pack_record", "unpack_record", "wire_size",
           "hand_off", "hand_off_async", "HandoffFuture"]

_TRANSIENT = (TimeoutError, ConnectionError, OSError, FaultInjected)

WIRE_VERSION = 1

# torch dtypes numpy cannot hold, each with the integer type of its width
# whose bytes carry it
_RAW = {torch.bfloat16: ("bfloat16", torch.int16),
        torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
        torch.float8_e5m2: ("float8_e5m2", torch.uint8)}
_BY_NAME = {name: (dt, carrier) for dt, (name, carrier) in _RAW.items()}


class KVHandoffError(RuntimeError):
    """A paged-KV handoff that could not be delivered (transient
    failures past the retry budget, or the receiving engine rejected
    the record). The router's recovery is re-prefill, not a crash."""


def _py(v):
    """JSON-safe scalar: numpy ints/floats/bools -> Python builtins."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def _manifest_and_bytes(a):
    """(dtype name, shape, a contiguous host buffer of its little-endian
    bytes) of one array; the buffer is a view, not a copy, where the
    array already lies contiguous on the host."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        name = str(a.dtype)
    else:
        t = a.detach().to("cpu").contiguous()
        if t.dtype in _RAW:
            name, carrier = _RAW[t.dtype]
            a = t.view(carrier).numpy()
        else:
            a = t.numpy()
            name = str(a.dtype)
    return name, list(a.shape), memoryview(a.reshape(-1)).cast("B")


def _carrier_np(name):
    """The numpy dtype whose bytes carry manifest dtype `name`."""
    if name in _BY_NAME:
        return torch.empty(0, dtype=_BY_NAME[name][1]).numpy().dtype
    return np.dtype(name)


def pack_record(record):
    """Serialize an export_kv record to one wire buffer (a bytearray)."""
    meta, arrays = {}, {}
    for key, val in record.items():
        if isinstance(val, (np.ndarray, torch.Tensor)):
            arrays[key] = _manifest_and_bytes(val)
        else:
            meta[key] = _py(val)
    meta["wire_version"] = WIRE_VERSION
    manifest = {k: [name, shape] for k, (name, shape, _b) in arrays.items()}
    head = json.dumps({"meta": meta, "arrays": manifest},
                      sort_keys=True).encode()
    # one copy of the bulk bytes: the join, into a writable buffer that
    # unpack_record can read in place
    return bytearray().join([struct.pack("<I", len(head)), head,
                             *(arrays[key][2] for key in sorted(arrays))])


def unpack_record(buf):
    """Inverse of pack_record; array bytes round-trip exactly. `buf` may be
    any bytes-like object: the arrays are views into a writable one (a
    bytearray, or a memoryview of one) and copies out of a read-only
    one."""
    (hlen,) = struct.unpack_from("<I", buf, 0)
    head = json.loads(bytes(buf[4:4 + hlen]).decode())
    meta = head["meta"]
    if meta.get("wire_version") != WIRE_VERSION:
        raise KVHandoffError(
            f"unknown handoff wire version {meta.get('wire_version')!r}")
    record = {k: v for k, v in meta.items() if k != "wire_version"}
    off = 4 + hlen
    for key in sorted(head["arrays"]):
        name, shape = head["arrays"][key]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        dt = _carrier_np(name)
        flat = np.frombuffer(buf, dtype=dt, count=n, offset=off)
        if not flat.flags.writeable:
            flat = flat.copy()
        t = torch.from_numpy(flat)
        if name in _BY_NAME:
            t = t.view(_BY_NAME[name][0])
        record[key] = t.reshape(shape)
        off += n * dt.itemsize
    if "prompt" in record:
        record["prompt"] = np.asarray(record["prompt"].numpy(), np.int32)
    return record


def wire_size(record):
    """Wire bytes this record serializes to (the handoff-bytes
    histogram's unit) without keeping the buffer."""
    return len(pack_record(record))


def hand_off(record, engine, retry=None):
    """Deliver one prefill->decode handoff: pass the `mesh.kv_handoff`
    fault site, pack + unpack the record over the wire, and install it
    on `engine` via import_kv. Returns (local_rid, wire_bytes,
    retries). Raises KVHandoffError when the transfer cannot be
    delivered (caller re-prefills); engine-side rejections
    (format mismatch, pool exhausted) propagate as KVHandoffError too.

    The transfer itself is host-side bytes: between engine steps, while
    the decode engine's double-buffered tiles are still in flight;
    import_kv only parks the request, so no decode work waits on the
    copy."""
    def _xfer():
        fault_point("mesh.kv_handoff", trace=record.get("trace_id"))
        return pack_record(record)

    try:
        if retry is not None:
            wire = retry.call(_xfer, op="mesh.kv_handoff")
            retries = retry.last_retries
        else:
            wire = _xfer()
            retries = 0
    except _TRANSIENT as e:
        raise KVHandoffError(f"handoff transfer failed: {e!r}") from e
    try:
        rid = engine.import_kv(unpack_record(wire))
    except (ValueError, MemoryError) as e:
        raise KVHandoffError(f"receiving engine rejected handoff: "
                             f"{e!r}") from e
    except _TRANSIENT as e:
        # a process-backed engine's import crosses the transport — its
        # death mid-import is a failed transfer, not a rejection
        raise KVHandoffError(f"handoff transfer failed: {e!r}") from e
    return rid, len(wire), retries


class HandoffFuture:
    """Delivery-complete handle for one asynchronous handoff. done() is
    a non-blocking poll; result() forces completion and returns
    (local_rid, wire_bytes, retries) or raises KVHandoffError with the
    same cause classification as hand_off (rejection cause ValueError/
    MemoryError -> caller tries the next target; transient cause ->
    caller re-prefills)."""

    __slots__ = ("_inner", "_nbytes", "_retries", "_resolved", "_value",
                 "_exc")

    def __init__(self, inner=None, nbytes=0, retries=0):
        self._inner = inner     # the transport future, when remote
        self._nbytes = int(nbytes)
        self._retries = int(retries)
        self._resolved = False
        self._value = None
        self._exc = None

    def _complete(self, value):
        self._resolved = True
        self._value = value

    def _fail(self, exc):
        self._resolved = True
        self._exc = exc

    def _translate(self, force):
        if self._resolved or self._inner is None:
            return
        if not force and not self._inner.done():
            return
        try:
            out = self._inner.result()
            if isinstance(out, tuple):      # transport (meta, payload)
                out = out[0]["rid"]
            self._complete((int(out), self._nbytes, self._retries))
        except (ValueError, MemoryError) as e:
            err = KVHandoffError(
                f"receiving engine rejected handoff: {e!r}")
            err.__cause__ = e
            self._fail(err)
        except _TRANSIENT as e:
            err = KVHandoffError(f"handoff transfer failed: {e!r}")
            err.__cause__ = e
            self._fail(err)

    def done(self):
        if not self._resolved and self._inner is not None \
                and self._inner.done():
            self._translate(force=True)
        return self._resolved

    def result(self):
        self._translate(force=True)
        if not self._resolved:
            raise KVHandoffError("handoff future never resolved")
        if self._exc is not None:
            raise self._exc
        return self._value


def hand_off_async(record, engine, retry=None):
    """hand_off, asynchronously: the `mesh.kv_handoff` fault/retry
    contract runs NOW (the site arms before bytes move, so a retried
    pack never double-imports), the transport copy overlaps with the
    caller's pump, and the returned HandoffFuture completes on
    delivery. Engines without `import_kv_async` (in-process pools)
    resolve synchronously through hand_off — behavior byte-identical to
    every earlier round."""
    importer = getattr(engine, "import_kv_async", None)
    if importer is None:
        fut = HandoffFuture()
        try:
            fut._complete(hand_off(record, engine, retry=retry))
        except KVHandoffError as e:
            fut._fail(e)
        return fut

    def _xfer():
        fault_point("mesh.kv_handoff", trace=record.get("trace_id"))
        return pack_record(record)

    try:
        if retry is not None:
            wire = retry.call(_xfer, op="mesh.kv_handoff")
            retries = retry.last_retries
        else:
            wire = _xfer()
            retries = 0
    except _TRANSIENT as e:
        fut = HandoffFuture()
        err = KVHandoffError(f"handoff transfer failed: {e!r}")
        err.__cause__ = e
        fut._fail(err)
        return fut
    return HandoffFuture(inner=importer(unpack_record(wire)),
                         nbytes=len(wire), retries=retries)

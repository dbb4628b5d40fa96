"""Process-native worker transport for the serving mesh.

Round 20 makes the mesh's workers real processes. A `ProcessReplica`
fronts a full ContinuousBatchingEngine that lives EITHER in this
process behind an in-memory loopback (deterministic, the shape the tests drive)
OR in a child process reached over a native TCP socket (the
plain `sys.executable -m` launch; worker.py is the child's
main). Both speak the same versioned length-prefixed frame protocol,
and the handoff's `pack_record` wire format IS the KV payload — a paged-KV
handoff crosses the transport as exactly the bytes `hand_off` already
round-trips, so byte-exact streams carry over unchanged.

Frame (version 1): `<4s magic><u32 header-len><u32 payload-len>` then a
sorted-key JSON header `{"v", "kind", "meta"}` and raw payload bytes.
Deterministic — the same call packs to the same frame.

Failure contract (`mesh.transport_send` fault site): the site arms
BEFORE a frame leaves the client, so a retried send can never
double-dispatch a non-idempotent op. Transient failures retry under the
client's RetryPolicy; exhaustion surfaces `TransportError` — a
ConnectionError subclass, so every existing _TRANSIENT classifier
(handoff retry-then-re-prefill, router failover) absorbs it without new
plumbing. A worker whose transport dies mid-session is treated exactly
like a killed process: the proxy latches lost, the pool tombstones its
lease, and the router re-prefills its uncommitted streams on survivors.

The router/commit/failover semantics stay transport-agnostic: the
`EngineProxy` mirrors the engine duck-type the MeshRouter already
drives (add_request / adopt_identity / step / finished / import_kv /
predicted_*), and greedy streams are pinned byte-identical to the
in-process pool across both transports.

Port: a copy of paddle_tpu/inference/mesh/transport.py, which imports no
JAX; its relative imports stay inside paddle_tpu_torch. The socket worker
is `python -m paddle_tpu_torch.inference.mesh.worker`, which builds its
engine on the device its spec names.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np

from ...distributed.fleet.elastic import ElasticManager
from ...framework.flags import flag_value
from ...observability.catalog import metric as _metric
from ...resilience.faults import FaultInjected, check, fault_point
from ...resilience.retry import RetryPolicy
from ..serving import BackpressureError
from .handoff import pack_record, unpack_record
from .replica import Replica, ReplicaPool

__all__ = ["TRANSPORT_VERSION", "TransportError", "TransportTimeout",
           "TransportFuture",
           "pack_frame", "unpack_frame", "send_frame", "recv_frame",
           "serve_request", "LoopbackClient", "SocketClient",
           "EngineProxy", "ProcessReplica", "ProcessReplicaPool"]

_TRANSIENT = (TimeoutError, ConnectionError, OSError, FaultInjected)

TRANSPORT_VERSION = 1
# a frame at least this long is received into a buffer of its own size
_BIG_FRAME = 1 << 20
_MAGIC = b"PTMW"        # paddle_tpu mesh worker

# network-chaos windows: how long a held reply stays hostage
# when the mesh.net_delay / mesh.net_stall sites are armed. The stall is
# deliberately SHORTER than the health detector's dead_elapsed_s default
# (2.0s) so a drill proves SLOW trips before DEAD.
_NET_DELAY_S = 0.05
_NET_STALL_S = 0.75
_DRAIN_SLICE_S = 0.02   # select granularity of a blocking drain


class TransportError(ConnectionError):
    """A framed round trip that could not be completed (send failed past
    the retry budget, the peer died, or a malformed/wrong-version frame
    arrived). Subclasses ConnectionError ON PURPOSE: every _TRANSIENT
    classifier in the mesh (handoff re-prefill, router failover) already
    knows how to recover from one."""


class TransportTimeout(TransportError):
    """A reply that did not land within its op budget. Still
    a TransportError — every transient classifier absorbs it — but the
    MEANING differs: the worker is gray (slow, owed a reply that stays
    pending), not dead, so callers must NOT latch the proxy lost on it.
    The health detector, not the timeout, decides when gray becomes
    dead."""


# --- frames ----------------------------------------------------------------

def _payload_parts(payload):
    """A payload as a list of byte buffers: one bytes-like object, or a
    list of them that goes on the wire back to back."""
    return list(payload) if isinstance(payload, (list, tuple)) \
        else [payload]


def _frame_head(kind, meta, plen):
    head = json.dumps({"v": TRANSPORT_VERSION, "kind": str(kind),
                       "meta": meta or {}}, sort_keys=True).encode()
    return struct.pack("<4sII", _MAGIC, len(head), plen) + head


def pack_frame(kind, meta=None, payload=b""):
    """Serialize one protocol frame. `meta` is JSON-safe scalars only;
    bulk bytes ride in `payload` untouched (a bytes-like object, or a
    list of them, concatenated)."""
    parts = _payload_parts(payload)
    plen = sum(memoryview(p).nbytes for p in parts)
    return b"".join([_frame_head(kind, meta, plen), *parts])


def _parse_head(buf, hlen):
    head = json.loads(bytes(buf[:hlen]).decode())
    if head.get("v") != TRANSPORT_VERSION:
        raise TransportError(
            f"unknown transport version {head.get('v')!r} "
            f"(this build speaks {TRANSPORT_VERSION})")
    return head["kind"], head.get("meta") or {}


def unpack_frame(buf):
    """Inverse of pack_frame -> (kind, meta, payload). Raises
    TransportError on bad magic, a truncated buffer, or a version this
    build does not speak (versioned so a mixed-version fleet fails
    typed, not with a JSON parse error mid-stream). The payload is a
    memoryview into `buf` (no copy of bulk bytes)."""
    if len(buf) < 12:
        raise TransportError(f"truncated frame ({len(buf)} bytes)")
    magic, hlen, plen = struct.unpack_from("<4sII", buf, 0)
    if magic != _MAGIC:
        raise TransportError(f"bad frame magic {magic!r}")
    if len(buf) != 12 + hlen + plen:
        raise TransportError(
            f"frame length mismatch ({len(buf)} != {12 + hlen + plen})")
    view = memoryview(buf)
    kind, meta = _parse_head(view[12:], hlen)
    return kind, meta, view[12 + hlen:]


def send_frame(sock, kind, meta=None, payload=b""):
    """Send one frame; a large payload's parts go out as they are, with
    no joined copy."""
    parts = _payload_parts(payload)
    plen = sum(memoryview(p).nbytes for p in parts)
    if plen < (1 << 16):
        sock.sendall(pack_frame(kind, meta, parts))
        return
    sock.sendall(_frame_head(kind, meta, plen))
    for p in parts:
        sock.sendall(p)


def _recv_exact(sock, n, deadline=None):
    """Read exactly n bytes into one buffer. `deadline` is an absolute
    perf_counter time; past it the read raises typed TransportTimeout (a
    half-open peer can no longer hang the caller forever)."""
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        if deadline is not None:
            rem = deadline - time.perf_counter()
            if rem <= 0.0:
                raise TransportTimeout(
                    f"frame receive expired mid-frame "
                    f"({got}/{n} bytes)")
            sock.settimeout(rem)
        try:
            k = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            raise TransportTimeout(
                f"frame receive expired mid-frame "
                f"({got}/{n} bytes)") from None
        if not k:
            raise TransportError("peer closed mid-frame")
        got += k
    return out


def recv_frame(sock, timeout=None):
    """Receive one frame; with `timeout` the WHOLE frame (prefix +
    header + payload) must land within that many seconds or typed
    TransportTimeout raises. Default stays blocking (the worker's serve
    loop legitimately waits forever for its parent). The payload is a
    memoryview into the frame's own buffer."""
    deadline = (None if timeout is None
                else time.perf_counter() + float(timeout))
    try:
        prefix = _recv_exact(sock, 12, deadline)
        magic, hlen, plen = struct.unpack("<4sII", prefix)
        if magic != _MAGIC:
            raise TransportError(f"bad frame magic {magic!r}")
        body = memoryview(_recv_exact(sock, hlen + plen, deadline))
        kind, meta = _parse_head(body, hlen)
        return kind, meta, body[hlen:]
    finally:
        if timeout is not None:
            try:
                sock.settimeout(None)
            except OSError:
                pass


# --- server-side dispatch ---------------------------------------------------
# One pure function shared by the in-process loopback and the child
# process's socket loop (worker.py), so both transports exercise the
# SAME op surface and marshalling.

# error bases a client can rehydrate typed; everything else surfaces as
# TransportError on the caller side. TimeoutError first: it subclasses
# OSError/ConnectionError in spirit but none of the bases below, and a
# worker-side deadline rejection must come back typed, not RuntimeError.
_ERROR_BASES = (("TimeoutError", TimeoutError),
                ("BackpressureError", BackpressureError),
                ("MemoryError", MemoryError),
                ("ValueError", ValueError),
                ("KeyError", KeyError))


def _marshal_error(e):
    base = next((name for name, cls in _ERROR_BASES
                 if isinstance(e, cls)), "RuntimeError")
    return "error", {"etype": type(e).__name__, "base": base,
                     "msg": str(e)}, b""


def _rehydrate(meta):
    base = meta.get("base")
    msg = f"{meta.get('etype')}: {meta.get('msg')}"
    if base == "TimeoutError":
        # a worker-side deadline rejection lands client-side as the
        # transport's own timeout type, so one except-clause covers
        # "reply too late" and "work refused as already expired"
        return TransportTimeout(msg)
    cls = dict(_ERROR_BASES).get(base)
    return cls(msg) if cls is not None else TransportError(msg)


def _finished_dict(req):
    return {"rid": req.rid, "generated": list(req.generated),
            "finish_reason": req.finish_reason, "tenant": req.tenant,
            "priority": req.priority, "trace_id": req.trace_id,
            "t_arrival": float(req.t_arrival),
            "t_first": None if req.t_first is None else float(req.t_first),
            "deadline_s": req.deadline_s,
            "shed_count": int(getattr(req, "shed_count", 0))}


def serve_request(engine, kind, meta, payload, exports=None):
    """Dispatch one decoded frame against `engine`; returns the reply
    frame parts (kind, meta, payload). `exports` is the worker-held
    list its prefill_sink appends to — drained into every step reply so
    handoff records reach the router without a side channel. Exceptions
    marshal as an error frame (never a torn reply).

    `meta["deadline"]` is the REMAINING seconds of the op's
    client-side budget at send time, popped before dispatch. Work that
    arrives already expired is rejected typed (TimeoutError base —
    rehydrates as TransportTimeout) instead of admitted: the engine
    would only expire it later with the blocks already spent."""
    meta = dict(meta or {})
    deadline = meta.pop("deadline", None)
    try:
        if (deadline is not None and float(deadline) <= 0.0
                and kind in ("add_request", "import_kv")):
            _metric("mesh_rpc_timeouts_total", op=kind).inc()
            raise TimeoutError(
                f"{kind} rejected: deadline expired before dispatch")
        if kind == "ping":
            return "ok", {"pid": os.getpid(),
                          "vocab": int(engine.embed_w.shape[0]),
                          "block_size": int(engine.pool.block_size)}, b""
        if kind == "add_request":
            prompt = np.frombuffer(payload, np.int32)
            rid = engine.add_request(prompt, **meta)
            return "ok", {"rid": int(rid)}, b""
        if kind == "cancel":
            ok = bool(engine.cancel(int(meta["rid"])))
            return "ok", {"cancelled": ok}, b""
        if kind == "adopt":
            ok = engine.adopt_identity(meta["rid"], meta["trace_id"],
                                       meta.get("t_arrival"))
            return "ok", {"adopted": bool(ok)}, b""
        if kind == "import_kv":
            rid = engine.import_kv(unpack_record(payload))
            return "ok", {"rid": int(rid)}, b""
        if kind == "step":
            dt = 0.0
            if engine.has_work():
                t0 = time.perf_counter()
                engine.step()
                dt = time.perf_counter() - t0
            fins = [_finished_dict(r) for r in engine.finished.values()]
            engine.finished.clear()
            wires = []
            if exports:
                wires = [pack_record(rec) for rec in exports]
                del exports[:]
            sched = getattr(engine, "scheduler", None)
            out = {"dt": dt,
                   "queue": [[r.tenant, r.priority] for r in engine.queue],
                   "lanes": [None if r is None else r.tenant
                             for r in engine.lanes],
                   "preempted": [[int(rid), req.tenant] for rid, (req, _l, _t)
                                 in engine._preempted.items()],
                   "has_work": bool(engine.has_work()),
                   "svc": engine.predicted_service_seconds(),
                   "brownout_level": (0 if sched is None
                                      else int(getattr(sched, "level", 0))),
                   "finished": fins,
                   "export_sizes": [len(w) for w in wires]}
            parts = []
            for w in wires:
                parts += [struct.pack("<I", len(w)), w]
            return "ok", out, parts
        if kind == "snapshot":
            costs = {key: {k: None if v is None else float(v)
                           for k, v in c.items()}
                     for key, c in engine.predicted_costs().items()}
            return "ok", {"costs": costs}, b""
        if kind == "shutdown":
            return "ok", {"bye": True}, b""
        raise ValueError(f"unknown transport op {kind!r}")
    except Exception as e:  # noqa: BLE001 — marshalled, never torn
        return _marshal_error(e)


# --- client futures ---------------------------------------------------------

class TransportFuture:
    """Delivery-complete handle for one asynchronous round trip. done()
    is a non-blocking poll; result() forces completion (draining the
    socket for real workers, counting down the simulated latency for
    loopback). Exceptions re-raise from result().

    result(timeout=...) bounds the wait: past the budget it raises typed
    TransportTimeout and counts `mesh_rpc_timeouts_total{op}` — the
    future stays pending (the reply is still owed; a later drain settles
    it), which is exactly the gray-failure shape: slow, not dead."""

    __slots__ = ("_client", "_resolved", "_value", "_exc", "_polls_left",
                 "_kind", "_ready_at")

    def __init__(self, client=None, polls=0, kind=None):
        self._client = client
        self._resolved = False
        self._value = None
        self._exc = None
        self._polls_left = int(polls)
        self._kind = kind
        # wall-clock hold (mesh.net_delay / mesh.net_stall on loopback):
        # the reply exists but has not "landed" before this time
        self._ready_at = None

    def _complete(self, value):
        self._resolved = True
        self._value = value

    def _fail(self, exc):
        self._resolved = True
        self._exc = exc

    def done(self):
        if not self._resolved and self._client is not None:
            self._client._drain(block=False)
        if not self._resolved:
            return False
        if self._ready_at is not None:
            if time.perf_counter() < self._ready_at:
                return False
            self._ready_at = None
        if self._polls_left > 0:
            # loopback latency model: the copy "lands" only after this
            # many polls — the deterministic stand-in for a NIC transfer
            # overlapping the decode pump
            self._polls_left -= 1
            return False
        return True

    def _timed_out(self, timeout):
        op = self._kind or "unknown"
        _metric("mesh_rpc_timeouts_total", op=op).inc()
        raise TransportTimeout(
            f"reply for {op!r} still owed past the "
            f"{timeout}s op budget (gray, not dead)")

    def result(self, timeout=None):
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        while not self._resolved:
            if self._client is None:
                raise TransportError("future abandoned with no client")
            self._client._drain(block=True, deadline=deadline)
        while self._ready_at is not None:
            now = time.perf_counter()
            if now >= self._ready_at:
                self._ready_at = None
                break
            if deadline is not None and now >= deadline:
                self._timed_out(timeout)
            time.sleep(min(0.0005, self._ready_at - now))
        self._polls_left = 0
        if self._exc is not None:
            raise self._exc
        return self._value


class _ClientBase:
    """Shared send discipline: every round trip passes the
    `mesh.transport_send` fault site INSIDE the retried closure and
    BEFORE dispatch, is counted per frame kind, and rehydrates error
    frames typed."""

    def __init__(self, retry=None):
        self._retry = retry

    def _guarded_send(self, kind, send):
        def _attempt():
            fault_point("mesh.transport_send", kind=kind)
            return send()
        try:
            if self._retry is not None:
                out = self._retry.call(_attempt, op="mesh.transport_send")
            else:
                out = _attempt()
        except _TRANSIENT as e:
            err = TransportError(f"transport send failed for {kind!r}: "
                                 f"{e!r}")
            err.__cause__ = e
            raise err
        _metric("mesh_transport_frames_total", kind=kind).inc()
        return out

    @staticmethod
    def _settle(fut, reply):
        kind, meta, payload = reply
        if kind == "error":
            fut._fail(_rehydrate(meta))
        else:
            fut._complete((meta, payload))

    def call(self, kind, meta=None, payload=b"", timeout=None):
        """Synchronous round trip -> (meta, payload). `timeout` bounds
        the reply wait (typed TransportTimeout past it)."""
        return self.call_async(kind, meta, payload).result(timeout=timeout)

    def _drain(self, block, deadline=None):
        raise NotImplementedError

    def close(self):
        pass


class LoopbackClient(_ClientBase):
    """In-process transport: frames still pack/unpack through the real
    protocol (so the tests cover the marshalling end to end), but
    dispatch runs immediately against the wrapped engine. `latency_polls`
    defers async completion by that many done() polls — the
    deterministic model of a transfer overlapping the decode pump."""

    def __init__(self, engine, retry=None, latency_polls=0):
        super().__init__(retry)
        self.engine = engine
        self.exports = []
        self.latency_polls = int(latency_polls)

    def _roundtrip(self, kind, meta, payload):
        k, m, p = unpack_frame(pack_frame(kind, meta, payload))
        rk, rm, rp = serve_request(self.engine, k, m, p,
                                   exports=self.exports)
        return unpack_frame(pack_frame(rk, rm, rp))

    def call_async(self, kind, meta=None, payload=b""):
        fut = TransportFuture(polls=(self.latency_polls
                                     if kind == "import_kv" else 0),
                              kind=kind)
        try:
            reply = self._guarded_send(
                kind, lambda: self._roundtrip(kind, meta, payload))
        except TransportError as e:
            fut._fail(e)
            return fut
        # network chaos: a delayed reply lands a beat late; a stalled
        # one is held hostage for a gray-failure window — the loopback
        # model of a saturated NIC or a paused peer. The dispatch above
        # already HAPPENED worker-side; only the reply is late, which is
        # exactly what makes gray failures nastier than crashes.
        hold = 0.0
        if check("mesh.net_delay"):
            hold = _NET_DELAY_S
        if check("mesh.net_stall"):
            hold = _NET_STALL_S
        if hold > 0.0:
            fut._ready_at = time.perf_counter() + hold
        self._settle(fut, reply)
        return fut


class SocketClient(_ClientBase):
    """One serial-ordered socket to a worker process. Requests are
    pipelined: call_async ships the frame now and the reply is drained
    later (replies arrive in request order, so the oldest pending future
    completes first) — the transport copy genuinely overlaps whatever
    the parent does between polls."""

    def __init__(self, sock, retry=None):
        super().__init__(retry)
        self.sock = sock
        self._pending: deque[TransportFuture] = deque()
        self._rxbuf = bytearray()     # partial frames survive a timeout
        # a large frame in flight: [its own buffer, bytes received so far]
        # (read straight into place, never through _rxbuf)
        self._big = None
        self._stall_until = 0.0       # mesh.net_stall hostage window

    def call_async(self, kind, meta=None, payload=b""):
        fut = TransportFuture(client=self, kind=kind)
        try:
            self._guarded_send(
                kind, lambda: send_frame(self.sock, kind, meta, payload))
        except TransportError as e:
            fut._fail(e)
            return fut
        self._pending.append(fut)
        return fut

    def _pop_frame(self):
        """One complete frame parsed off the receive buffer, else None.
        A truncated tail STAYS buffered — a timed-out wait never loses
        mid-frame bytes, so the late reply is still whole when the next
        drain resumes it (the round-20 blocking recv_frame could only
        hang or tear here)."""
        if self._big is not None:
            big, got = self._big
            if got < len(big):
                return None
            self._big = None
            return unpack_frame(big)
        buf = self._rxbuf
        if len(buf) < 12:
            return None
        magic, hlen, plen = struct.unpack_from("<4sII", buf, 0)
        if magic != _MAGIC:
            raise TransportError(f"bad frame magic {magic!r}")
        end = 12 + hlen + plen
        if len(buf) < end:
            if end >= _BIG_FRAME:
                # the rest lands in a buffer of the frame's size
                big = bytearray(end)
                big[:len(buf)] = buf
                self._big = [big, len(buf)]
                self._rxbuf = bytearray()
            return None
        if len(buf) == end:     # the whole buffer is this frame: take it
            frame, self._rxbuf = buf, bytearray()
        else:
            frame = buf[:end]
            del buf[:end]
        return unpack_frame(frame)

    def _recv(self):
        """Read what the kernel holds: into the large frame in flight, in
        place, else up to 64 KiB onto _rxbuf. Returns the byte count (0:
        the peer closed)."""
        if self._big is not None:
            big, got = self._big
            n = self.sock.recv_into(memoryview(big)[got:])
            self._big[1] = got + n
            return n
        data = self.sock.recv(1 << 16)
        self._rxbuf += data
        return len(data)

    def _fatal(self, err, cause=None):
        """Hard transport death (peer closed, torn stream): every owed
        reply is unrecoverable — fail them all. Deadline expiry NEVER
        comes through here."""
        if cause is not None:
            err.__cause__ = cause
        while self._pending:
            self._pending.popleft()._fail(err)
        raise err

    def _drain(self, block, deadline=None):
        """Settle owed replies. Non-blocking: consume whatever the
        kernel already holds. Blocking: wait in short select slices
        until ONE reply settles or `deadline` (absolute perf_counter)
        passes — expiry raises typed TransportTimeout with `_pending`
        PRESERVED (the worker is gray; its replies are still owed and
        the serial order still holds)."""
        import select
        while self._pending:
            try:
                frame = self._pop_frame()
            except TransportError as e:
                self._fatal(e)
            if frame is not None:
                self._settle(self._pending.popleft(), frame)
                if block:
                    return
                continue
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                op = self._pending[0]._kind or "unknown"
                _metric("mesh_rpc_timeouts_total", op=op).inc()
                raise TransportTimeout(
                    f"reply for {op!r} not delivered within the op "
                    "budget (worker slow or stalled; replies stay "
                    "owed — gray, not dead)")
            wait = 0.0
            if block:
                wait = _DRAIN_SLICE_S
                if deadline is not None:
                    wait = min(wait, max(0.0, deadline - now))
            if self._stall_until > now:
                # a hostage reply (mesh.net_stall): refuse to read until
                # the stall lifts — bytes wait in the kernel buffer,
                # exactly a paused peer from this side of the wire
                if not block:
                    return
                time.sleep(min(max(wait, 0.0005),
                               self._stall_until - now))
                continue
            ready, _w, _x = select.select([self.sock], [], [], wait)
            if ready and check("mesh.net_delay"):
                ready = []      # this poll sees nothing (late packet)
            if ready and check("mesh.net_stall"):
                self._stall_until = now + _NET_STALL_S
                ready = []
            if not ready:
                if not block:
                    return
                continue
            try:
                got = self._recv()
            except _TRANSIENT as e:
                self._fatal(
                    TransportError(f"transport receive failed: {e!r}"),
                    cause=e)
            if not got:
                self._fatal(TransportError("peer closed mid-stream"))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# --- the engine duck-type over a client ------------------------------------

class _Stub:
    """Occupancy mirror entry: what the mesh-wide admission view and the
    router's load ranking actually read off a replica engine."""

    __slots__ = ("tenant", "priority", "generated")

    def __init__(self, tenant="-", priority="interactive"):
        self.tenant = tenant
        self.priority = priority
        self.generated = []


class _PoolStub:
    __slots__ = ("block_size",)

    def __init__(self, block_size):
        self.block_size = int(block_size)


class _RemoteFinished:
    """Finished-request record rehydrated from a step reply — the fields
    the router commit, the load harness, and mesh reports consume."""

    __slots__ = ("rid", "generated", "done", "finish_reason", "tenant",
                 "priority", "trace_id", "t_arrival", "t_first",
                 "deadline_s", "shed_count")

    def __init__(self, d):
        self.rid = d["rid"]
        self.generated = list(d["generated"])
        self.done = True
        self.finish_reason = d["finish_reason"]
        self.tenant = d["tenant"]
        self.priority = d["priority"]
        self.trace_id = d["trace_id"]
        self.t_arrival = d["t_arrival"]
        self.t_first = d["t_first"]
        self.deadline_s = d["deadline_s"]
        self.shed_count = d["shed_count"]


class EngineProxy:
    """The ContinuousBatchingEngine duck-type the MeshRouter drives,
    backed by a transport client. State the router reads synchronously
    (queue/lanes/_preempted occupancy, finished, svc, brownout) mirrors
    from the last step reply; mutations (add_request, adopt_identity,
    import_kv) are framed calls. A dead transport latches `lost`: the
    proxy stops accepting work (“BackpressureError” on admit, has_work
    False) and fires on_lost once so the pool can tombstone the lease —
    from the router's point of view, exactly a killed replica."""

    def __init__(self, client, vocab, block_size, name="worker",
                 op_timeout_s=None):
        self.client = client
        self.name = name
        self.queue = []
        self.lanes = []
        self._preempted = {}
        self.finished = {}
        self.prefill_sink = None
        self.scheduler = None
        self.brownout_level = 0
        self.lost = False
        self.on_lost = None
        self.embed_w = np.zeros((int(vocab), 1), np.float32)
        self.pool = _PoolStub(block_size)
        self._has_work = False
        self._svc = None
        self.op_timeout_s = (float(flag_value("mesh_rpc_timeout_s"))
                             if op_timeout_s is None
                             else float(op_timeout_s))
        # gray-failure bookkeeping: a step reply that missed its budget
        # is PARKED (resumed next pump so finished streams and exports
        # are never lost); a resource-creating RPC that missed its
        # budget is remembered so the late-admitted work is cancelled
        self._inflight_step = None
        self._abandoned = []

    def _budget(self, deadline_s=None, t_arrival=None):
        """Seconds this op may wait: the per-op flag budget, tightened
        by the request's REMAINING end-to-end deadline (router →
        prefill → handoff → decode all draw from the same clock).
        Clamps at 0 so an already-expired op still ships — the worker
        rejects it typed server-side, which is the contract under test."""
        b = self.op_timeout_s
        if deadline_s is not None:
            rem = (float(deadline_s) if t_arrival is None
                   else (float(t_arrival) + float(deadline_s)
                         - time.perf_counter()))
            b = min(b, max(0.0, rem))
        return b

    def _mark_lost(self):
        if self.lost:
            return
        self.lost = True
        self.queue = []
        self.lanes = []
        self._preempted = {}
        self._has_work = False
        if self.on_lost is not None:
            self.on_lost(self)

    def _reap_abandoned(self):
        """Resolve RPCs whose client-side budget expired: when the late
        reply finally lands with a rid, that work was admitted on the
        worker AFTER the caller gave up — withdraw it so no ghost stream
        decodes (and no pool blocks leak)."""
        if not self._abandoned:
            return
        keep = []
        for fut in self._abandoned:
            if not fut.done():
                keep.append(fut)
                continue
            try:
                reply, _p = fut.result()
            except Exception:   # noqa: BLE001 — the op failed anyway
                continue
            rid = reply.get("rid")
            if rid is not None:
                self.cancel(int(rid))
        self._abandoned = keep

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                    seed=0, deadline_s=None, tenant="-",
                    priority="interactive"):
        if self.lost:
            raise BackpressureError(f"worker {self.name} lost")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        budget = self._budget(deadline_s)
        meta = {"max_new_tokens": int(max_new_tokens),
                "eos_token_id": eos_token_id, "do_sample": bool(do_sample),
                "temperature": float(temperature), "top_k": int(top_k),
                "top_p": float(top_p), "seed": seed,
                "deadline_s": deadline_s, "tenant": tenant,
                "priority": priority, "deadline": budget}
        fut = self.client.call_async("add_request", meta, prompt.tobytes())
        try:
            reply, _p = fut.result(timeout=budget)
        except TransportTimeout:
            # gray: the worker may still admit late — remember the
            # future so the eventual rid is withdrawn, and fail THIS
            # placement without latching the replica lost
            self._abandoned.append(fut)
            raise BackpressureError(
                f"worker {self.name} add_request timed out") from None
        except TransportError:
            self._mark_lost()
            raise BackpressureError(f"worker {self.name} lost") from None
        self.queue.append(_Stub(tenant, priority))
        self._has_work = True
        return int(reply["rid"])

    def adopt_identity(self, rid, trace_id, t_arrival=None):
        if self.lost:
            return False
        try:
            reply, _p = self.client.call(
                "adopt", {"rid": int(rid), "trace_id": str(trace_id),
                          "t_arrival": t_arrival},
                timeout=self.op_timeout_s)
        except TransportTimeout:
            return False    # late 'adopted' reply drains harmlessly
        except TransportError:
            self._mark_lost()
            return False
        return bool(reply["adopted"])

    def cancel(self, rid):
        """Withdraw one stream on the worker (a hedge loser, or an RPC
        that timed out client-side but landed late). Fire-and-forget:
        the reply settles on a later drain, and a lost transport needs
        no withdrawal — the work died with the process."""
        if self.lost:
            return False
        self.client.call_async("cancel", {"rid": int(rid)})
        return True

    def import_kv(self, record):
        """Synchronous wire import; rejection rehydrates typed
        (ValueError / MemoryError) so hand_off's classification is
        unchanged; a dead transport surfaces TransportError (transient
        by construction). The remaining request deadline rides the
        frame: an import that lands expired is refused server-side
        (TransportTimeout here → transfer-failure → re-prefill)."""
        if self.lost:
            raise TransportError(f"worker {self.name} lost")
        budget = self._budget(record.get("deadline_s"),
                              record.get("t_arrival"))
        fut = self.client.call_async("import_kv", {"deadline": budget},
                                     pack_record(record))
        try:
            reply, _p = fut.result(timeout=budget)
        except TransportTimeout:
            self._abandoned.append(fut)     # late import = ghost stream
            raise
        except TransportError:
            self._mark_lost()
            raise
        self._has_work = True
        return int(reply["rid"])

    def import_kv_async(self, record):
        """Asynchronous wire import: the frame ships now, the future
        completes on delivery — the decode pump keeps running while the
        copy is in flight."""
        if self.lost:
            fut = TransportFuture()
            fut._fail(TransportError(f"worker {self.name} lost"))
            return fut
        budget = self._budget(record.get("deadline_s"),
                              record.get("t_arrival"))
        fut = self.client.call_async("import_kv", {"deadline": budget},
                                     pack_record(record))
        self._has_work = True
        return fut

    def step(self):
        """One worker step; returns the WORKER-side wall seconds (the
        honest per-chip cost for the simulated-parallel clock — parent
        IPC overhead excluded on purpose). A reply that misses the op
        budget is PARKED and resumed next pump (replies are serial, so
        nothing is reordered): the pump reports no progress, the health
        detector accrues suspicion, and no finished stream or export is
        ever dropped."""
        if self.lost:
            return 0.0
        self._reap_abandoned()
        fut = self._inflight_step
        self._inflight_step = None
        if fut is None:
            fut = self.client.call_async("step")
            budget = self.op_timeout_s
        else:
            # resuming a parked reply: poll one short slice only — the
            # pump must keep cycling so the health detector can accrue
            # suspicion on this replica instead of the router blocking
            budget = min(self.op_timeout_s, _DRAIN_SLICE_S)
        try:
            reply, blob = fut.result(timeout=budget)
        except TransportTimeout:
            self._inflight_step = fut
            return 0.0
        except TransportError:
            self._mark_lost()
            return 0.0
        self.queue = [_Stub(t, p) for t, p in reply["queue"]]
        self.lanes = [None if t is None else _Stub(t)
                      for t in reply["lanes"]]
        self._preempted = {int(rid): (_Stub(t), None, None)
                           for rid, t in reply["preempted"]}
        self._has_work = bool(reply["has_work"])
        self._svc = reply["svc"]
        self.brownout_level = int(reply["brownout_level"])
        for d in reply["finished"]:
            self.finished[int(d["rid"])] = _RemoteFinished(d)
        off = 0
        for size in reply["export_sizes"]:
            (n,) = struct.unpack_from("<I", blob, off)
            assert n == size
            rec = unpack_record(blob[off + 4:off + 4 + n])
            off += 4 + n
            if self.prefill_sink is not None:
                self.prefill_sink(rec)
        return float(reply["dt"])

    def has_work(self):
        return not self.lost and self._has_work

    def predicted_service_seconds(self, output_tokens=32):
        return self._svc

    def predicted_costs(self):
        if self.lost:
            return {}
        try:
            reply, _p = self.client.call("snapshot",
                                         timeout=self.op_timeout_s)
        except TransportTimeout:
            return {}   # advisory data: stale beats blocking the pump
        except TransportError:
            self._mark_lost()
            return {}
        return reply["costs"]

    def shutdown(self):
        if self.lost:
            return
        try:
            self.client.call("shutdown", timeout=self.op_timeout_s)
        except TransportError:
            pass
        self.client.close()


# --- process-backed replicas ------------------------------------------------

class ProcessReplica(Replica):
    """A Replica whose engine is an EngineProxy. step() trusts the
    worker-reported wall (the per-chip cost) and a lost transport walks
    the same death path as pool.kill."""

    __slots__ = ("proc",)

    def __init__(self, name, proxy, role="both", proc=None, **kw):
        super().__init__(name, proxy, role=role, **kw)
        self.proc = proc
        proxy.on_lost = self._on_lost

    def _on_lost(self, _proxy):
        self.alive = False
        for _ in range(self.breaker.failure_threshold):
            self.breaker.record_failure()

    def step(self):
        if not self.engine.has_work():
            return 0.0
        dt = self.engine.step()
        if dt > 0.0:
            self.step_seconds += dt
            self.steps += 1
        return dt


def _launch_worker(name, spec, listener, worker_env=None):
    """Start one worker child (a plain sys.executable subprocess that
    builds its engine on the device its spec names). Returns (proc, spec
    path); the spec file goes once the worker has connected."""
    specfile = tempfile.NamedTemporaryFile(
        mode="w", suffix=f".{name}.json", delete=False)
    json.dump(spec, specfile)
    specfile.close()
    host, port = listener.getsockname()[:2]
    env = dict(os.environ)
    if worker_env:
        env.update(worker_env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.mesh.worker",
         "--connect", f"{host}:{port}", "--name", name,
         "--spec", specfile.name],
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))))
    return proc, specfile.name


def _accept_worker(name, spec, proc, specpath, listener, early):
    """Accept `proc`'s transport connection and ping it. Workers started
    side by side connect in any order: a connection whose hello names
    another pid is parked in `early` (pid -> (client, hello)) for that
    worker's own accept. Returns (proc, client, hello-meta)."""
    accept_timeout = spec.get("accept_timeout_s")
    if accept_timeout is None:
        accept_timeout = flag_value("mesh_worker_accept_timeout_s")
    listener.settimeout(float(accept_timeout))
    try:
        while proc.pid not in early:
            try:
                sock, _addr = listener.accept()
            except socket.timeout:
                proc.kill()
                raise TransportTimeout(
                    f"worker {name} never connected within "
                    f"{float(accept_timeout):g}s (accept expiry)") from None
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            client = SocketClient(sock)
            hello, _p = client.call("ping", timeout=float(accept_timeout))
            early[int(hello["pid"])] = (client, hello)
    finally:
        try:
            os.unlink(specpath)
        except OSError:
            pass
    client, hello = early.pop(proc.pid)
    return proc, client, hello


def _spawn_worker(name, spec, listener, worker_env=None):
    """Launch one worker child and accept its transport connection.
    Returns (proc, sock, hello-meta)."""
    proc, specpath = _launch_worker(name, spec, listener, worker_env)
    return _accept_worker(name, spec, proc, specpath, listener, {})


class ProcessReplicaPool(ReplicaPool):
    """A ReplicaPool whose workers live behind the frame transport.

    transport="loopback": engines are built in-process by
    `build_engine` and wrapped in LoopbackClient proxies — every frame
    marshals through the real protocol, deterministically (the tested
    shape). Membership is the parent-held lease per replica, exactly
    like ReplicaPool; `threaded_beats=True` switches those leases to
    ElasticManager.start() daemon heartbeats and makes pool.beat() a
    no-op (beat failures are counted, never raised into serving).

    transport="socket": each worker is a CHILD PROCESS (worker.py)
    running a full engine built from `engine_spec` (a JSON-safe dict —
    callables cannot cross a process boundary). The worker registers
    its OWN lease over the shared native TCPStore and runs threaded
    heartbeats; the parent keeps an unregistered manager per replica
    purely to read membership and write the tombstone on kill.
    """

    def __init__(self, build_engine=None, n=2, transport="loopback",
                 engine_spec=None, threaded_beats=False, latency_polls=0,
                 client_retry="default", worker_env=None,
                 op_timeout_s=None, **kw):
        if transport not in ("loopback", "socket"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "socket" and engine_spec is None:
            raise ValueError("socket transport needs engine_spec "
                             "(a callable cannot cross a process)")
        if transport == "loopback" and build_engine is None:
            raise ValueError("loopback transport needs build_engine")
        self.transport = transport
        self.engine_spec = engine_spec
        self.threaded_beats = bool(threaded_beats)
        self.latency_polls = int(latency_polls)
        self.worker_env = worker_env
        self.op_timeout_s = op_timeout_s    # None -> FLAGS_mesh_rpc_timeout_s
        self._client_retry = (RetryPolicy(
            max_attempts=3, base_delay=0.001, max_delay=0.01, seed=0,
            sleep=lambda _s: None) if client_retry == "default"
            else client_retry)
        self._listener = None
        # socket workers started by _prepare_replicas (name -> (proc, spec
        # path)) and connections accepted before their turn (pid ->
        # (client, hello))
        self._launched = {}
        self._early = {}
        if transport == "socket":
            self._listener = socket.socket()
            self._listener.bind(("127.0.0.1", 0))
            self._listener.listen(16)
            build_engine = build_engine or (lambda: None)
        super().__init__(build_engine, n=n, **kw)
        if self.threaded_beats or self.transport == "socket":
            # parent-held leases beat on daemon threads (loopback); the
            # socket workers' own managers already started theirs
            for rep in self.replicas:
                if rep.manager is not None and rep.manager._registered:
                    rep.manager.start()

    # ReplicaPool builds replicas through this hook
    def _make_replica(self, i, role, failure_threshold, reset_timeout):
        name = f"replica{i}"
        if self.transport == "loopback":
            engine = self._build_one_engine()
            proxy = EngineProxy(
                LoopbackClient(engine, retry=self._client_retry,
                               latency_polls=self.latency_polls),
                vocab=engine.embed_w.shape[0],
                block_size=engine.pool.block_size, name=name,
                op_timeout_s=self.op_timeout_s)
            if role == "prefill":
                # prefill workers export instead of decoding locally;
                # records buffer worker-side and ride the step reply —
                # delivery is via the frame protocol, like a process
                self._wire_loopback_sink(engine, proxy)
            return ProcessReplica(name, proxy, role=role,
                                  failure_threshold=failure_threshold,
                                  reset_timeout=reset_timeout)
        spec = self._worker_spec(name, role)
        if name in self._launched:
            proc, specpath = self._launched.pop(name)
        else:
            proc, specpath = _launch_worker(name, spec, self._listener,
                                            self.worker_env)
        proc, client, hello = _accept_worker(name, spec, proc, specpath,
                                             self._listener, self._early)
        client._retry = self._client_retry
        proxy = EngineProxy(client, vocab=hello["vocab"],
                            block_size=hello["block_size"], name=name,
                            op_timeout_s=self.op_timeout_s)
        return ProcessReplica(name, proxy, role=role, proc=proc,
                              failure_threshold=failure_threshold,
                              reset_timeout=reset_timeout)

    def _worker_spec(self, name, role):
        spec = dict(self.engine_spec)
        spec["role"] = role
        spec["node_id"] = name
        spec["store"] = {"host": "127.0.0.1", "port": int(self.store.port),
                         "heartbeat_interval": self._hb_interval}
        return spec

    def _prepare_replicas(self, roles):
        """Socket workers start side by side: each child's interpreter,
        imports and engine build overlap the others'."""
        if self.transport != "socket":
            return
        for i, role in enumerate(roles):
            name = f"replica{i}"
            self._launched[name] = _launch_worker(
                name, self._worker_spec(name, role), self._listener,
                self.worker_env)

    @staticmethod
    def _wire_loopback_sink(engine, proxy):
        client = proxy.client

        def _sink(record):
            client.exports.append(record)
        engine.prefill_sink = _sink

    def _bind_membership(self, rep, n):
        if self.transport == "socket":
            # the WORKER owns its lease (registered + threaded beats in
            # the child); the parent manager stays unregistered — used
            # only to read alive_nodes and compute the tombstone key
            rep.manager = ElasticManager(
                self.store, node_id=rep.name, np_range=(1, n),
                heartbeat_interval=self._hb_interval,
                retry_policy=self._retry)
            return
        super()._bind_membership(rep, n)

    def beat(self):
        if self.threaded_beats or self.transport == "socket":
            return      # daemon beat threads own the leases
        super().beat()

    def kill(self, name):
        rep = self.by_name(name)
        if rep.alive and rep.proc is not None:
            rep.proc.kill()     # SIGKILL: the real mid-decode death
            rep.proc.wait(timeout=30)
        if self.transport == "socket" and rep.alive:
            # the dead child cannot tombstone itself; the parent writes
            # the empty lease so membership converges immediately
            self.store.set(ElasticManager.PREFIX + name, b"")
            rep.alive = False
            for _ in range(rep.breaker.failure_threshold):
                rep.breaker.record_failure()
            return rep
        return super().kill(name)

    def retire(self, name):
        rep = super().retire(name)
        eng = rep.engine
        if isinstance(eng, EngineProxy):
            eng.shutdown()
        if self.transport == "socket":
            self.store.set(ElasticManager.PREFIX + name, b"")
            if rep.proc is not None:
                try:
                    rep.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    rep.proc.kill()
        return rep

    def spawn(self, role="both"):
        rep = super().spawn(role=role)
        if (self.threaded_beats or self.transport == "socket") \
                and rep.manager is not None and rep.manager._registered:
            rep.manager.start()
        return rep

    def close(self):
        for rep in self.replicas:
            if rep.alive:
                try:
                    self.retire(rep.name)
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
        if self._listener is not None:
            self._listener.close()

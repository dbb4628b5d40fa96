"""The port's process-native serving mesh (inference/mesh/transport.py,
controller.py, worker.py), running the cases of the reference's
tests/test_mesh_process.py against the port's classes.

Replicas behind the versioned frame transport, in-process loopback
proxies and real child processes over TCP, serve the streams of the
in-process pool; the frames are the reference's bytes; an async hand-off
parks the stream until delivery while the decode pump runs; the
MeshController acts on autoscale verdicts and latches back to advisory
on a fault. The socket workers are the port's own
(`python -m paddle_tpu_torch.inference.mesh.worker`) on the CPU: their
streams equal an in-process engine built by the worker's build_engine
from the same spec, and a killed worker fails over with no stream lost.
"""

import socket
import threading

import pytest

from paddle_tpu.inference.mesh import transport as jtransport
from paddle_tpu_torch.inference.mesh import (MeshController, MeshRouter,
                                             ProcessReplicaPool, ReplicaPool,
                                             TransportError, worker)
from paddle_tpu_torch.inference.mesh.transport import (
    SocketClient, pack_frame, recv_frame, send_frame, serve_request,
    unpack_frame)
from paddle_tpu_torch.resilience import faults
from torch_mesh_parity import SPEC as _SPEC
from torch_mesh_parity import dense as _dense_reference
from torch_mesh_parity import (factory, no_new_series,  # noqa: F401
                               port_model, prompts, serve)
from torch_one_thread import one_torch_thread  # noqa: F401


def _factory(**kw):
    return factory(**kw)


def _model():
    return port_model()


def _prompts(n):
    return prompts(n, seed=7)


def _socket_pool(**kw):
    """A pool of port workers in child processes on the CPU."""
    return ProcessReplicaPool(transport="socket", engine_spec=_SPEC,
                              store_port=0, **kw)


class TestFrameProtocol:
    def test_round_trip(self):
        payload = bytes(range(256)) * 3
        buf = pack_frame("step", {"a": 1, "b": None}, payload)
        kind, meta, out = unpack_frame(buf)
        assert (kind, meta, out) == ("step", {"a": 1, "b": None}, payload)
        # deterministic: same call packs to the same bytes
        assert pack_frame("step", {"a": 1, "b": None}, payload) == buf

    def test_unknown_version_rejected(self):
        import json
        import struct
        buf = pack_frame("ping", {})
        magic, hlen, plen = struct.unpack_from("<4sII", buf, 0)
        head = json.loads(buf[12:12 + hlen])
        head["v"] = 99
        new_head = json.dumps(head, sort_keys=True).encode()
        tampered = struct.pack("<4sII", magic, len(new_head), plen) \
            + new_head + buf[12 + hlen:]
        with pytest.raises(TransportError, match="version"):
            unpack_frame(tampered)

    def test_bad_magic_and_truncation_rejected(self):
        buf = pack_frame("ping", {})
        with pytest.raises(TransportError, match="magic"):
            unpack_frame(b"XXXX" + buf[4:])
        with pytest.raises(TransportError, match="truncated"):
            unpack_frame(buf[:8])
        with pytest.raises(TransportError, match="length"):
            unpack_frame(buf + b"junk")

    def test_unknown_op_marshals_typed_error(self):
        eng = _factory()()
        kind, meta, _p = serve_request(eng, "frobnicate", {}, b"")
        assert kind == "error"
        assert meta["base"] == "ValueError"


class TestLoopbackParity:
    def test_dp_streams_byte_identical_to_in_process_pool(self):
        prompts = _prompts(4)
        base_pool = ReplicaPool(_factory(), n=2, store_port=0)
        base_router = MeshRouter(base_pool)
        for p in prompts:
            base_router.add_request(p, max_new_tokens=8)
        want = base_router.run()

        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  store_port=0)
        router = MeshRouter(pool)
        for p in prompts:
            router.add_request(p, max_new_tokens=8)
        got = router.run()
        assert got == want
        assert all(rep.routed >= 1 for rep in pool)

    def test_disaggregated_streams_byte_identical(self):
        prompts = _prompts(4)
        model = _model()
        refs = [_dense_reference(model, p, 8) for p in prompts]
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  disaggregate=True,
                                  store_port=0)
        router = MeshRouter(pool)
        rids = [router.add_request(p, max_new_tokens=8) for p in prompts]
        out = router.run()
        for rid, ref in zip(rids, refs):
            assert out[rid] == ref, rid
        rep = router.mesh_report()
        assert rep["handoffs"]["ok"] == len(prompts)
        assert rep["open"] == 0

    def test_threaded_beats_keep_membership_and_make_beat_noop(self):
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  threaded_beats=True,
                                  store_port=0)
        assert sorted(pool.alive_nodes()) == ["replica0", "replica1"]
        # synchronous beat is a no-op: the daemon threads own the leases
        pool.beat()
        for rep in pool:
            assert rep.manager._hb_thread is not None
            assert rep.manager._hb_thread.is_alive()
        assert sorted(pool.alive_nodes()) == ["replica0", "replica1"]

    def test_transport_loss_walks_the_replica_down_path(self):
        # exhaust every send attempt of the first admission: the worker
        # latches lost and the survivor serves all streams
        prompts = _prompts(3)
        model = _model()
        refs = [_dense_reference(model, p, 6) for p in prompts]
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  store_port=0)
        router = MeshRouter(pool)
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        with faults.injected_faults(
                "mesh.transport_send:1:ConnectionError;"
                "mesh.transport_send:2:ConnectionError;"
                "mesh.transport_send:3:ConnectionError"):
            out = router.run()
        assert len(pool.alive()) == 1
        assert router._failovers.get("admit_failed", 0) >= 1
        for rid, ref in zip(rids, refs):
            assert out[rid] == ref, rid
        assert router.mesh_report()["open"] == 0


class TestAsyncHandoff:
    def test_delivery_overlaps_decode_pump(self):
        # latency_polls delays import completion by N done() polls: the
        # router must park the handoff as PENDING and keep pumping
        # decode steps while the copy is "in flight"
        prompts = _prompts(3)
        model = _model()
        refs = [_dense_reference(model, p, 8) for p in prompts]
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  disaggregate=True, latency_polls=3,
                                  store_port=0)
        router = MeshRouter(pool)
        rids = [router.add_request(p, max_new_tokens=8) for p in prompts]
        saw_pending = 0
        for _ in range(300):
            router.step()
            saw_pending = max(saw_pending, len(router._pending_handoffs))
            if not router.has_work():
                break
        out = dict(router.finished)
        assert saw_pending >= 1, \
            "async handoff never parked a pending delivery"
        for rid, ref in zip(rids, refs):
            assert out[rid].generated == ref, rid
        assert router._handoffs["ok"] == len(prompts)
        assert router.mesh_report()["open"] == 0

    def test_sync_pools_resolve_immediately(self):
        # engines without import_kv_async (plain in-process pool) pass
        # through hand_off synchronously — nothing ever parks pending
        prompts = _prompts(2)
        pool = ReplicaPool(_factory(), n=2, disaggregate=True,
                           store_port=0)
        router = MeshRouter(pool)
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        saw_pending = 0
        for _ in range(300):
            router.step()
            saw_pending = max(saw_pending, len(router._pending_handoffs))
            if not router.has_work():
                break
        assert saw_pending == 0
        assert sorted(router.finished) == rids


class TestController:
    def _mesh(self, **kw):
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  store_port=0)
        router = MeshRouter(pool)
        ctl = MeshController(router, **kw)
        router.controller = ctl
        return pool, router, ctl

    def test_scale_up_spawns_and_registers(self):
        pool, router, ctl = self._mesh(max_replicas=3)
        ctl.act({"action": "scale_up"})
        assert len(pool.alive()) == 3
        assert ctl.actions["scale_up"] == 1
        assert sorted(pool.alive_nodes()) \
            == sorted(r.name for r in pool.alive())
        # ceiling respected: a second verdict is a no-op
        ctl.act({"action": "scale_up"})
        assert len(pool.alive()) == 3 and ctl.actions["scale_up"] == 1

    def test_scale_down_drains_before_tombstone(self):
        pool, router, ctl = self._mesh(min_replicas=1, drain_rounds=50)
        prompts = _prompts(4)
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        router.step()           # streams in flight on both replicas
        ctl.act({"action": "scale_down"})
        assert ctl.actions["drain_begin"] == 1
        victim = next(iter(ctl._drain_waits))
        assert pool.by_name(victim).draining
        out = router.run()      # pump: drain completes, THEN retire
        assert sorted(out) == rids          # no stream lost to the drain
        assert ctl.actions["scale_down"] == 1
        assert ctl.actions["drain_forced"] == 0
        assert not pool.by_name(victim).alive
        assert victim not in pool.alive_nodes()     # lease tombstoned
        # accounting closure: every drain_begin resolved exactly once
        assert ctl.actions["drain_begin"] == \
            ctl.actions["scale_down"] + ctl.actions["drain_forced"]
        assert not ctl._drain_waits
        assert router.mesh_report()["open"] == 0

    def test_stuck_drain_is_forced_through_kill(self):
        pool, router, ctl = self._mesh(min_replicas=1, drain_rounds=2)
        prompts = _prompts(3)
        model = _model()
        refs = [_dense_reference(model, p, 24) for p in prompts]
        rids = [router.add_request(p, max_new_tokens=24) for p in prompts]
        router.step()           # long streams: the drain cannot finish
        ctl.act({"action": "scale_down"})
        victim = next(iter(ctl._drain_waits))
        out = router.run()
        assert ctl.actions["drain_forced"] == 1
        assert ctl.actions["drain_begin"] == \
            ctl.actions["scale_down"] + ctl.actions["drain_forced"]
        assert not pool.by_name(victim).alive
        # the forced kill used the drilled failover path: every stream
        # re-prefilled on the survivor, byte-identical
        for rid, ref in zip(rids, refs):
            assert out[rid] == ref, rid
        assert router.mesh_report()["open"] == 0

    def test_fault_latches_advisory_only_serving_identical(self):
        pool, router, ctl = self._mesh()
        prompts = _prompts(3)
        model = _model()
        refs = [_dense_reference(model, p, 6) for p in prompts]
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        with faults.injected_faults("mesh.controller_act:1:FaultInjected"):
            out = router.run()
        assert not ctl.enabled
        assert ctl.actions["latch_off"] == 1
        for rid, ref in zip(rids, refs):
            assert out[rid] == ref, rid
        # latched: later verdicts are ignored
        ctl.act({"action": "scale_up"})
        assert len(pool.alive()) == 2 and ctl.actions["scale_up"] == 0

    def test_min_replicas_floor_respected(self):
        pool, router, ctl = self._mesh(min_replicas=2)
        ctl.act({"action": "scale_down"})
        assert ctl.actions["drain_begin"] == 0
        assert len(pool.alive()) == 2


class TestBrownoutRouting:
    def test_browned_out_replica_demoted_at_equal_load(self):
        pool = ReplicaPool(_factory(), n=2, store_port=0)
        # replica0 reports a browned-out serving plane (no scheduler
        # attached: the attribute mirror is what process proxies use)
        pool.by_name("replica0").engine.brownout_level = 3
        assert pool.by_name("replica0").snapshot()[
            "serving_brownout_level"] == 3
        router = MeshRouter(pool)
        router.add_request(_prompts(1)[0], max_new_tokens=4)
        router.step()
        # the healthy replica wins the tie at equal (zero) load
        assert pool.by_name("replica1").routed == 1
        assert pool.by_name("replica0").routed == 0
        # a hint, never a wall: alone, the browned-out replica serves
        router.kill_replica("replica1", why="test")
        rid = router.add_request(_prompts(1)[0], max_new_tokens=4)
        out = router.run()
        assert rid in out


def test_frames_are_the_reference_bytes():
    payload = bytes(range(256))
    for kind, meta in (("step", {"a": 1, "b": None}), ("ping", {}),
                       ("error", {"base": "ValueError", "msg": "x"})):
        buf = pack_frame(kind, meta, payload)
        assert buf == jtransport.pack_frame(kind, meta, payload)
        assert jtransport.unpack_frame(buf) == (kind, meta, payload)


def test_large_frames_land_whole_and_in_order():
    """A frame past the large-frame size is received into a buffer of its
    own, in pieces, and the frame after it still lands whole; sent as
    parts, it is the bytes of one packed frame."""
    a, b = socket.socketpair()
    big = bytes(range(256)) * (3 * 4096 + 7)        # about 3 MiB
    try:
        client = SocketClient(a)
        futs = [client.call_async("step"), client.call_async("ping")]

        def peer():
            for _ in futs:
                recv_frame(b)
            send_frame(b, "ok", {"n": 1}, [big[:1000], big[1000:]])
            send_frame(b, "ok", {"n": 2}, b"tail")
        t = threading.Thread(target=peer)
        t.start()
        meta, payload = futs[0].result(timeout=30)
        assert meta == {"n": 1} and bytes(payload) == big
        meta, payload = futs[1].result(timeout=30)
        assert meta == {"n": 2} and bytes(payload) == b"tail"
        t.join(timeout=30)
        assert not t.is_alive()
        assert pack_frame("ok", {"n": 1}, [big[:1000], big[1000:]]) \
            == pack_frame("ok", {"n": 1}, big)
    finally:
        a.close()
        b.close()


class TestSocketWorkers:
    def test_disaggregated_workers_match_spec_engine(self):
        ps = _prompts(3)
        want = serve(worker.build_engine(_SPEC), ps, n=6)
        pool = _socket_pool(n=2, disaggregate=True)
        try:
            assert sorted(pool.alive_nodes()) == ["replica0", "replica1"]
            router = MeshRouter(pool)
            assert serve(router, ps, n=6) == want
            assert router._handoffs["ok"] == len(ps)
            assert router.mesh_report()["open"] == 0
        finally:
            pool.close()
        assert all(rep.proc.returncode is not None for rep in pool)

    def test_killed_worker_fails_over_no_stream_lost(self):
        ps = _prompts(4)
        want = serve(worker.build_engine(_SPEC), ps, n=16)
        pool = _socket_pool(n=2)
        try:
            router = MeshRouter(pool)
            rids = [router.add_request(p, max_new_tokens=16) for p in ps]
            router.step()       # streams mid-decode on both workers
            victim = max(pool.alive(), key=lambda r: r.load()).name
            router.kill_replica(victim, why="kill9")    # SIGKILL child
            out = router.run()
            assert len(pool.alive()) == 1
            assert victim not in pool.alive_nodes()     # tombstoned
            assert router._failovers.get("replica_down", 0) >= 1
            assert [out[r] for r in rids] == want
            assert router.mesh_report()["open"] == 0
        finally:
            pool.close()

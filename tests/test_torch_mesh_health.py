"""The port's gray-failure immunity for the serving mesh (inference/
mesh/health.py and the transport's deadlines), running the cases of the
reference's tests/test_mesh_health.py against the port's classes.

Every transport op carries a deadline budget, and a reply that misses it
raises the typed TransportTimeout (never a hang, never a latched-lost
replica); the HealthDetector scores busy replicas that make no progress
into healthy, slow and dead with elapsed floors (SLOW demotes from
routing, only DEAD kills); a parked hand-off past its deadline_s finishes
as a timeout and releases the blocks of both replicas; a stalled replica
trips SLOW with the streams the dense forward's, and a hedge commits the
first finisher once. Streams are held to the port's dense generate()."""

import socket
import time

import numpy as np
import pytest

from paddle_tpu_torch.framework.flags import flag_value
from paddle_tpu_torch.inference.mesh import (HealthDetector, LatencyBudget,
                                             MeshRouter, ProcessReplicaPool,
                                             TransportError,
                                             TransportTimeout, VERDICTS)
from paddle_tpu_torch.inference.mesh.transport import (
    EngineProxy, LoopbackClient, _rehydrate, pack_frame, recv_frame,
    serve_request)
from paddle_tpu_torch.resilience import faults
from torch_mesh_parity import TIGHT as _TIGHT
from torch_mesh_parity import counter as _counter
from torch_mesh_parity import counter_sum as _counter_sum
from torch_mesh_parity import (factory, metrics, no_new_series,  # noqa: F401
                               port_model)
from torch_mesh_parity import dense as _dense_reference
from torch_mesh_parity import prompts
from torch_one_thread import one_torch_thread  # noqa: F401


def _factory(**kw):
    return factory(**kw)


def _model():
    return port_model()


def _prompts(n):
    return prompts(n, seed=11)


class TestDeadlineTransport:
    def test_recv_frame_truncated_under_timeout_raises_typed(self):
        # a peer that sends half a frame then goes silent used to hang
        # _recv_exact forever; with a timeout it must raise the TYPED
        # timeout (still a TransportError, so every transient classifier
        # absorbs it) instead of blocking or mis-reporting peer-closed
        a, b = socket.socketpair()
        try:
            buf = pack_frame("step", {"dt": 0}, b"x" * 64)
            b.sendall(buf[:len(buf) - 10])      # header lands, payload torn
            t0 = time.perf_counter()
            with pytest.raises(TransportTimeout, match="mid-frame"):
                recv_frame(a, timeout=0.1)
            assert time.perf_counter() - t0 < 5.0
            assert issubclass(TransportTimeout, TransportError)
            assert issubclass(TransportTimeout, ConnectionError)
            # the socket is handed back blocking, not poisoned by the
            # expired per-read timeout
            assert a.gettimeout() is None
        finally:
            a.close()
            b.close()

    def test_recv_frame_whole_frame_within_timeout(self):
        a, b = socket.socketpair()
        try:
            b.sendall(pack_frame("ping", {"k": 1}, b"payload"))
            kind, meta, payload = recv_frame(a, timeout=1.0)
            assert (kind, meta, payload) == ("ping", {"k": 1}, b"payload")
        finally:
            a.close()
            b.close()

    def test_expired_deadline_rejected_server_side(self, metrics):
        # work that arrives already past its budget is REFUSED before
        # admission (the engine would only expire it later with the
        # blocks already spent) and the rejection rehydrates typed
        eng = _factory()()
        prompt = np.arange(6, dtype=np.int32)
        kind, meta, _ = serve_request(
            eng, "add_request", {"deadline": 0.0, "max_new_tokens": 4},
            prompt.tobytes())
        assert kind == "error"
        assert meta["base"] == "TimeoutError"
        assert not eng.has_work()               # never admitted
        err = _rehydrate(meta)
        assert isinstance(err, TransportTimeout)
        assert _counter(metrics, "mesh_rpc_timeouts_total",
                        op="add_request") == 1.0

    def test_op_budget_follows_flag_and_override(self):
        # the registered knobs exist with their documented defaults, and
        # the proxy budget prefers an explicit per-pool override
        assert flag_value("mesh_rpc_timeout_s") == 30.0
        assert flag_value("mesh_worker_accept_timeout_s") == 120.0
        eng = _factory()()
        proxy = EngineProxy(LoopbackClient(eng),
                            vocab=eng.embed_w.shape[0],
                            block_size=eng.pool.block_size)
        assert proxy.op_timeout_s == 30.0
        proxy2 = EngineProxy(LoopbackClient(eng),
                             vocab=eng.embed_w.shape[0],
                             block_size=eng.pool.block_size,
                             op_timeout_s=0.5)
        assert proxy2.op_timeout_s == 0.5


class TestHealthDetector:
    def test_verdict_registry_is_closed(self):
        assert set(VERDICTS) == {"healthy", "slow", "dead"}

    def test_slow_trips_before_dead_and_recovers(self):
        det = HealthDetector(slow_phi=1.0, dead_phi=8.0,
                             slow_elapsed_s=0.25, dead_elapsed_s=2.0)
        # progress every 0.1s while busy: suspicion stays 0
        for i in range(4):
            v, phi = det.observe("r0", 0.1 * i, True, (i,))
            assert (v, phi) == ("healthy", 0.0)
        # progress freezes with work owed: verdicts escalate in order
        seen = []
        for t in (0.4, 0.6, 1.0, 5.0):
            v, phi = det.observe("r0", t, True, (3,))
            seen.append(v)
        assert seen[0] == "healthy"     # elapsed 0.1 < slow floor
        assert "slow" in seen and "dead" in seen
        assert seen.index("slow") < seen.index("dead")
        # any counter movement resets suspicion instantly
        v, phi = det.observe("r0", 5.1, True, (4,))
        assert (v, phi) == ("healthy", 0.0)

    def test_idle_replica_is_never_suspect(self):
        det = HealthDetector()
        for t in (0.0, 10.0, 500.0):
            v, phi = det.observe("r0", t, False, (0,))
            assert (v, phi) == ("healthy", 0.0)
        assert det.suspicion("r0", 1000.0) == 0.0
        # work showing up only STARTS the clock — no instant verdict
        # from the idle gap
        v, _ = det.observe("r0", 1000.0, True, (0,))
        assert v == "healthy"

    def test_dead_needs_elapsed_floor_not_just_phi(self):
        # microsecond intervals make phi explode instantly; the wall
        # floor must still protect the replica from one hiccup
        det = HealthDetector(slow_phi=1.0, dead_phi=8.0,
                             slow_elapsed_s=0.25, dead_elapsed_s=2.0,
                             floor_s=0.0001)
        for i in range(8):
            det.observe("r0", 0.001 * i, True, (i,))
        v, phi = det.observe("r0", 0.5, True, (7,))
        assert phi > 8.0 and v == "slow"        # huge phi, wall < 2s
        v, _ = det.observe("r0", 3.0, True, (7,))
        assert v == "dead"

    def test_forget_starts_clean(self):
        det = HealthDetector(slow_phi=0.5, slow_elapsed_s=0.1)
        det.observe("r0", 0.0, True, (0,))
        assert det.observe("r0", 50.0, True, (0,))[0] != "healthy"
        det.forget("r0")
        v, phi = det.observe("r0", 50.0, True, (0,))
        assert (v, phi) == ("healthy", 0.0)


class TestLatencyBudget:
    def test_uncalibrated_returns_none(self):
        b = LatencyBudget(min_samples=4)
        for _ in range(3):
            b.observe(0.1)
            assert b.budget() is None
        b.observe(0.1)
        assert b.budget() is not None

    def test_quantile_times_multiplier(self):
        b = LatencyBudget(q=0.95, multiplier=2.0, floor_s=0.01,
                          min_samples=4)
        for _ in range(20):
            b.observe(0.1)      # all mass in the (0.064, 0.128] bucket
        assert 2.0 * 0.064 <= b.budget() <= 2.0 * 0.128

    def test_floor_wins_over_tiny_service(self):
        b = LatencyBudget(floor_s=5.0, min_samples=1)
        b.observe(0.001)
        assert b.budget() == 5.0


class TestEngineCancel:
    def test_cancel_queued_request_before_admission(self):
        eng = _factory()()
        rid = eng.add_request(np.arange(6, dtype=np.int32),
                              max_new_tokens=4)
        assert eng.cancel(rid) is True
        assert not eng.has_work()
        assert rid not in eng.finished          # withdrawn, not failed
        assert eng.cancel(rid) is False         # second cancel: gone
        assert eng.cancel(9999) is False

    def test_cancel_decoding_lane_releases_blocks(self):
        eng = _factory()()
        keep = eng.add_request(np.arange(6, dtype=np.int32),
                               max_new_tokens=4)
        drop = eng.add_request(np.arange(8, dtype=np.int32),
                               max_new_tokens=4)
        eng.step()                              # both admitted to lanes
        assert drop in eng.pool.tables
        assert eng.cancel(drop) is True
        assert drop not in eng.pool.tables      # blocks back in the pool
        while eng.has_work():
            eng.step()
        assert keep in eng.finished and drop not in eng.finished


class TestHandoffDeadline:
    def test_parked_handoff_past_deadline_times_out_and_releases(
            self, metrics):
        # a stream wedged in handoff_pending past its
        # deadline_s must finish reason=timeout via the router sweep
        # (neither engine can see it — prefill already released, decode
        # never admitted) and the late-landing import must be withdrawn
        # so BOTH replicas' pool blocks come back
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  disaggregate=True, latency_polls=60,
                                  store_port=0)
        router = MeshRouter(pool)
        rid = router.add_request(_prompts(1)[0], max_new_tokens=8,
                                 deadline_s=0.2)
        saw_pending = False
        for _ in range(400):
            router.step()
            saw_pending = saw_pending or bool(router._pending_handoffs)
            if rid in router.finished:
                break
            time.sleep(0.005)
        assert saw_pending, "handoff never parked pending"
        rec = router.finished[rid]
        assert rec.finish_reason == "timeout"
        assert _counter(metrics, "serving_timeouts_total",
                        where="handoff") >= 1.0
        # drain the in-flight copy: _poll_pending's done-cleanup
        # withdraws the import for the expired stream
        for _ in range(400):
            if not router._pending_handoffs and not router.has_work():
                break
            router.step()
        assert not router._pending_handoffs
        for rep in pool:
            real = rep.engine.client.engine
            assert real.pool.tables == {}, rep.name
        assert router.mesh_report()["open"] == 0


class TestSlowDemotionAndHedge:
    def test_net_stall_trips_slow_not_dead_streams_identical(
            self, metrics):
        # one stalled step reply: the victim is demoted SLOW (out of
        # _ranked, never tombstoned), its parked work is hedged on the
        # survivor, and every greedy stream still matches the dense
        # reference byte-for-byte
        prompts = _prompts(2)
        model = _model()
        refs = [_dense_reference(model, p, 6) for p in prompts]
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  op_timeout_s=0.05,
                                  store_port=0)
        router = MeshRouter(pool, health=HealthDetector(**_TIGHT),
                            hedge_budget_s=0.3)
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        router.step()
        router.step()           # warm: placements land before the stall
        with faults.injected_faults("mesh.net_stall:1:TimeoutError"):
            out = router.run()
            assert faults.injected_counts().get("mesh.net_stall") == 1
        for rid, ref in zip(rids, refs):
            assert out[rid] == ref, rid
        assert len(pool.alive()) == 2           # SLOW, never killed
        assert _counter_sum(metrics, "mesh_rpc_timeouts_total") >= 1.0
        assert _counter_sum(metrics, "mesh_slow_demotions_total") >= 1.0
        assert _counter(metrics, "mesh_failovers_total",
                        reason="replica_down") == 0.0
        assert router.mesh_report()["open"] == 0

    def test_hedge_first_finish_wins_exactly_once(self, metrics):
        # the hedger races a sibling placement; the commit map takes the
        # first finisher and drops the loser unread — each rid appears
        # exactly once with the greedy reference tokens
        prompts = _prompts(2)
        model = _model()
        refs = [_dense_reference(model, p, 6) for p in prompts]
        pool = ProcessReplicaPool(_factory(), n=2, transport="loopback",
                                  op_timeout_s=0.05,
                                  store_port=0)
        router = MeshRouter(pool, health=HealthDetector(**_TIGHT),
                            hedge_budget_s=0.2)
        rids = [router.add_request(p, max_new_tokens=6) for p in prompts]
        router.step()
        router.step()
        with faults.injected_faults("mesh.net_stall:1:TimeoutError"):
            out = router.run()
        launched = _counter(metrics, "mesh_hedges_total",
                            outcome="launched")
        if launched:            # hedges fired: every launch settles
            settled = (_counter(metrics, "mesh_hedges_total",
                                outcome="win")
                       + _counter(metrics, "mesh_hedges_total",
                                  outcome="cancelled"))
            assert settled >= launched
        assert sorted(out) == sorted(rids)
        for rid, ref in zip(rids, refs):
            assert out[rid] == ref, rid
        assert router.mesh_report()["open"] == 0

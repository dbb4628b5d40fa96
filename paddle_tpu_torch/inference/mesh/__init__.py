"""Disaggregated serving mesh. reference: paddle_tpu/inference/mesh/.

Turns the single-process ContinuousBatchingEngine into a cluster of
worker replicas — in-process or real child processes:

- `replica.ReplicaPool` — N engine replicas with lease-based membership
  over TCPStore + ElasticManager; killing one tombstones its lease.
- `handoff` — byte-exact serialized paged-KV transfer between prefill
  and decode workers, in the pool's raw block-storage format (native
  and int8/fp8 quantized alike), with retry-then-re-prefill semantics
  at the `mesh.kv_handoff` fault site. `hand_off_async` returns a
  HandoffFuture so the transport copy overlaps the decode pump. The
  blocks go through the host: read back from the prefill replica's
  pool, packed, unpacked and written into the decode replica's.
- `router.MeshRouter` — the front door: DRR/priority admission over a
  mesh-wide view, headroom-ranked replica choice behind the
  `mesh.route` fault site and per-replica CircuitBreakers, at-most-once
  stream commit, and replica-failover re-prefill that keeps greedy
  streams byte-identical to a single-replica run.
- `transport` — the versioned length-prefixed frame protocol
  (`mesh.transport_send` fault site), EngineProxy mirroring the engine
  duck-type over it, and ProcessReplicaPool running each replica as a
  child process (`worker.py`) holding its own mesh lease.
- `controller.MeshController` — consumes AutoscaleAdvisor verdicts and
  ACTS: spawn + lease-register on scale_up, drain-before-tombstone on
  scale_down; any failure latches it back to advisory-only
  (`mesh.controller_act` fault site).
- `health` — gray-failure immunity: every transport op carries a
  deadline budget (typed `TransportTimeout` past it, the replica stays
  gray, never latched lost), a `HealthDetector` scores per-replica
  progress into healthy / slow / dead verdicts (SLOW is demoted from
  routing, only DEAD walks the replica_down path), and the router
  hedges placements that outlive a quantile latency budget — first
  finish wins through the at-most-once commit map (`mesh.net_delay` /
  `mesh.net_stall` fault sites).

On one card the in-process replicas share it (and may share one model
object); each has its own engine, pool and captured decode graphs.
"""

from .controller import MeshController
from .handoff import (HandoffFuture, KVHandoffError, hand_off,
                      hand_off_async, pack_record, unpack_record,
                      wire_size)
from .health import HealthDetector, LatencyBudget, VERDICTS
from .replica import Replica, ReplicaPool, ROLES
from .router import MeshRequest, MeshRouter
from .transport import (EngineProxy, LoopbackClient, ProcessReplica,
                        ProcessReplicaPool, SocketClient, TransportError,
                        TransportTimeout, pack_frame, serve_request,
                        unpack_frame)

__all__ = ["KVHandoffError", "hand_off", "hand_off_async",
           "HandoffFuture", "pack_record", "unpack_record", "wire_size",
           "Replica", "ReplicaPool", "ROLES", "MeshRequest",
           "MeshRouter", "TransportError", "TransportTimeout",
           "pack_frame", "unpack_frame",
           "serve_request", "LoopbackClient", "SocketClient",
           "EngineProxy", "ProcessReplica", "ProcessReplicaPool",
           "MeshController", "HealthDetector", "LatencyBudget",
           "VERDICTS"]

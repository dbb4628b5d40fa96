"""Replica pool for the disaggregated serving mesh.

A `Replica` wraps one ContinuousBatchingEngine with a role (prefill /
decode / both), a per-replica CircuitBreaker (the router's failover
signal), and cumulative step-time accounting. A `ReplicaPool` builds N
of them as in-process workers — on one card, or the CPU, in place of N
separate serving processes — and runs their membership through the real
distributed substrate: every replica registers a lease with an
ElasticManager over a shared TCPStore, the pool beats the leases
synchronously each pump (deterministic: no heartbeat threads in tests),
and killing a replica tombstones its lease so `alive()` drops it the
same way a lost process drops out of an etcd registry.

With `tp=True` each engine is built under the sharding passes'
`mesh_scope` over a two-way "mp" mesh, as the reference's is. The port's
meshes are logical (their process ids lie on the card or cards there
are: distributed/placement.py), so it does so at any card count, where
the reference builds the plain engine below two devices.

Port: reference paddle_tpu/inference/mesh/replica.py; everything but
`_build_sharded` is a copy.
"""

from __future__ import annotations

import time

from ...distributed.store import TCPStore
from ...distributed.fleet.elastic import ElasticManager
from ...resilience.retry import CircuitBreaker, RetryPolicy

__all__ = ["Replica", "ReplicaPool", "ROLES"]

ROLES = ("both", "prefill", "decode")


class Replica:
    """One engine worker in the mesh: engine + role + breaker + the
    accounting the router balances and reports on."""

    __slots__ = ("name", "engine", "role", "breaker", "alive", "draining",
                 "routed", "step_seconds", "steps", "manager",
                 "finished_count", "tokens_out", "sampler")

    def __init__(self, name, engine, role="both",
                 failure_threshold=3, reset_timeout=30.0):
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r}; "
                             f"one of {ROLES}")
        self.name = name
        self.engine = engine
        self.role = role
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      reset_timeout=reset_timeout,
                                      op=f"mesh.replica.{name}")
        self.alive = True
        self.draining = False    # controller scale-down victim: the
                                 # router stops placing new work here
        self.routed = 0          # requests the router committed here
        self.step_seconds = 0.0  # cumulative engine.step wall on this worker
        self.steps = 0
        self.finished_count = 0  # streams harvested off this worker
        self.tokens_out = 0      # tokens those streams committed
        self.manager = None      # bound by ReplicaPool
        # per-replica observability sampler: attached by the router's
        # MeshCollector (federation.py) and ticked from its pump; a dead
        # replica keeps the sampler so its series freeze, not vanish
        self.sampler = None

    def can_prefill(self):
        return self.role in ("both", "prefill")

    def can_decode(self):
        return self.role in ("both", "decode")

    def load(self):
        """Queued + occupied + parked work — the router's tiebreaker
        when the cost model has not calibrated yet."""
        eng = self.engine
        return (len(eng.queue)
                + sum(r is not None for r in eng.lanes)
                + len(eng._preempted))

    def step(self):
        """One engine step, walled. Returns the step's wall seconds (0.0
        when the engine was idle) — the router folds these into the
        simulated-parallel mesh clock."""
        if not self.engine.has_work():
            return 0.0
        t0 = time.perf_counter()
        self.engine.step()
        dt = time.perf_counter() - t0
        self.step_seconds += dt
        self.steps += 1
        return dt

    def brownout_level(self):
        """The worker's current brownout rung (0 = normal): read off
        its scheduler in-process, mirrored from the last step reply for
        process-backed workers. The router's ranking DEMOTES browned-out
        replicas — a hint, never a correctness input."""
        sch = getattr(self.engine, "scheduler", None)
        if sch is not None:
            return int(getattr(sch, "level", 0))
        return int(getattr(self.engine, "brownout_level", 0))

    def snapshot(self):
        """Per-replica slice of the mesh report: liveness, routing and
        SLO-capacity state."""
        eng = self.engine
        svc = eng.predicted_service_seconds()
        # harvested streams plus whatever finished since the last pump
        tokens = self.tokens_out + sum(len(r.generated)
                                       for r in eng.finished.values())
        return {
            "role": self.role,
            "alive": self.alive,
            "draining": self.draining,
            "serving_brownout_level": self.brownout_level(),
            "breaker": self.breaker.state,
            "routed": self.routed,
            "finished": self.finished_count + len(eng.finished),
            "tokens": tokens,
            "steps": self.steps,
            "step_seconds": round(self.step_seconds, 4),
            "tok_per_s": (round(tokens / self.step_seconds, 1)
                          if self.step_seconds > 0 else None),
            "predicted_service_s": svc,
            "load": self.load(),
        }


def _build_sharded(build_engine, tp):
    """Build one engine, with `tp=True` under the sharding passes' mesh
    scope over ProcessMesh([0, 1], ["mp"]) (reference :130-144).

    As in the reference, this shards nothing: the scope is open only while
    `build_engine()` runs, and the engine's programs compile lazily, at
    their first dispatch, after it closed; nor does the engine give its
    programs sharding rules or input shardings. So a tp engine and a plain
    one compile the same programs (their shard_prop declines with
    "no-annotations"), in the reference and in the port."""
    if not tp:
        return build_engine()
    import torch
    from ...distributed.placement import ProcessMesh
    from ...pir.shard_prop import mesh_scope
    mesh = ProcessMesh([0, 1], dim_names=["mp"],
                       device="cuda" if torch.cuda.is_available() else "cpu")
    with mesh_scope(mesh):
        return build_engine()


class ReplicaPool:
    """N in-process engine replicas with lease-based membership.

    build_engine: zero-arg engine factory (called N times; seed inside
    the factory for identical replicas — disaggregation requires every
    worker to hold the same weights).
    roles: per-replica role list, or None for the default split:
    n == 1 -> ("both",); disaggregate -> first half prefill, second
    half decode (at least one of each); else all "both".
    """

    def __init__(self, build_engine, n=2, roles=None, disaggregate=False,
                 tp=False, store=None, store_port=46101,
                 heartbeat_interval=5.0, failure_threshold=3,
                 reset_timeout=30.0):
        n = int(n)
        if n < 1:
            raise ValueError("a mesh needs at least one replica")
        if roles is None:
            if disaggregate and n >= 2:
                n_prefill = max(1, n // 2)
                roles = (["prefill"] * n_prefill
                         + ["decode"] * (n - n_prefill))
            else:
                roles = ["both"] * n
        if len(roles) != n:
            raise ValueError(f"{len(roles)} roles for {n} replicas")
        if disaggregate and n >= 2:
            if not any(r in ("both", "prefill") for r in roles):
                raise ValueError("disaggregated mesh has no prefill worker")
            if not any(r in ("both", "decode") for r in roles):
                raise ValueError("disaggregated mesh has no decode worker")
        self.disaggregate = bool(disaggregate) and n >= 2
        self._build_engine = build_engine
        self._tp = bool(tp)
        self._hb_interval = float(heartbeat_interval)
        self._failure_threshold = failure_threshold
        self._reset_timeout = reset_timeout
        self._next_idx = n      # spawn() names stay unique after retires
        # membership substrate: one shared in-process store, one elastic
        # lease per replica. Heartbeats are synchronous (beat()) so the
        # pool is deterministic under test; production workers would
        # call manager.start() for the threaded loop instead.
        self.store = store if store is not None else TCPStore(
            is_master=True, port=store_port, timeout=2)
        self._retry = RetryPolicy(max_attempts=2, base_delay=0.01,
                                  seed=0, sleep=lambda _s: None)
        self.replicas = []
        self._prepare_replicas(roles)
        for i in range(n):
            rep = self._make_replica(i, roles[i], failure_threshold,
                                     reset_timeout)
            self._bind_membership(rep, n)
            self.replicas.append(rep)

    def _prepare_replicas(self, roles):
        """Called once before the first replicas are made (subclass hook:
        ProcessReplicaPool starts every worker process here, so they
        start up side by side)."""

    def _build_one_engine(self):
        return _build_sharded(self._build_engine, self._tp)

    def _make_replica(self, i, role, failure_threshold, reset_timeout):
        """Build one worker (subclass hook: ProcessReplicaPool builds
        transport-backed proxies here instead of in-process engines)."""
        return Replica(f"replica{i}", self._build_one_engine(),
                       role=role, failure_threshold=failure_threshold,
                       reset_timeout=reset_timeout)

    def _bind_membership(self, rep, n):
        """Register the replica's lease (subclass hook: socket workers
        register their OWN lease from the child process)."""
        rep.manager = ElasticManager(
            self.store, node_id=rep.name, np_range=(1, n),
            heartbeat_interval=self._hb_interval,
            retry_policy=self._retry)
        rep.manager.register()

    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, i):
        return self.replicas[i]

    def by_name(self, name):
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(name)

    def alive(self):
        return [rep for rep in self.replicas if rep.alive]

    def beat(self):
        """Refresh every live replica's lease (synchronous heartbeat —
        one store write per replica)."""
        for rep in self.replicas:
            if rep.alive:
                rep.manager._beat()

    def alive_nodes(self):
        """Membership as the store sees it (lease-fresh, tombstones
        dropped) — the cross-check that the elastic registry agrees
        with the pool's own liveness flags."""
        if not self.replicas:
            return []
        return self.replicas[0].manager.alive_nodes()

    def kill(self, name):
        """Simulate losing a replica process: tombstone its lease, mark
        it dead, and force its breaker open so the router fails fast
        instead of probing a corpse. The engine object is NOT drained —
        exactly like a killed process, whatever it was doing is gone;
        the router re-prefills its uncommitted streams elsewhere."""
        rep = self.by_name(name)
        if not rep.alive:
            return rep
        rep.alive = False
        rep.manager.deregister()
        for _ in range(rep.breaker.failure_threshold):
            rep.breaker.record_failure()
        return rep

    def spawn(self, role="both"):
        """Grow the pool live: build one new worker, register its
        lease, and add it to the rotation (the MeshController's
        scale-up action). The new replica draws traffic as soon as the
        router's next ranking sees it."""
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r}; "
                             f"one of {ROLES}")
        i = self._next_idx
        self._next_idx += 1
        rep = self._make_replica(i, role, self._failure_threshold,
                                 self._reset_timeout)
        self._bind_membership(rep, len(self.replicas) + 1)
        self.replicas.append(rep)
        return rep

    def retire(self, name):
        """Clean scale-down exit for a DRAINED worker: tombstone its
        lease and drop it from the rotation. Unlike kill(), the engine
        was idle — nothing is lost, no breaker slam, no failover."""
        rep = self.by_name(name)
        if not rep.alive:
            return rep
        rep.alive = False
        rep.draining = False
        rep.manager.deregister()
        return rep

    def prefill_targets(self):
        return [r for r in self.alive() if r.can_prefill()]

    def decode_targets(self):
        return [r for r in self.alive() if r.can_decode()]

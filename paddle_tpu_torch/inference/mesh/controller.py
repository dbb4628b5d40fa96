"""MeshController: the autoscale loop closed — verdicts become actions.

The AutoscaleAdvisor is advisory by design: it emits
hysteresis-gated ±1 scale verdicts and drain-time predictions, and the
mesh ignores them. The MeshController consumes those verdicts and ACTS
on the live ReplicaPool:

  scale_up     pool.spawn(): build + lease-register a new worker; it
               draws traffic on the router's next ranking pass.
  scale_down   pick a victim (role invariants preserved: a
               disaggregated mesh always keeps >=1 prefill and >=1
               decode worker), mark it DRAINING — the router stops
               placing new work there, in-flight streams finish through
               the existing preemption/handoff machinery — then retire
               it: tombstone the lease only when the worker is idle.
               A drain that exceeds `drain_rounds` pumps is FORCED
               through router.kill_replica, i.e. the drilled
               re-prefill-on-survivors path — slower, never wrong.

Every action is flight-recorded (kind "controller") and counted
(`mesh_controller_actions_total{action}`). Failure contract
(`mesh.controller_act` fault site): ANY controller exception latches it
back to advisory-only (enabled=False, counted latch_off +
serving_runtime_degradations_total{what=controller_advisory}) while
serving continues byte-identically — the controller can only ever make
the pool bigger/smaller, never touch a stream.

Port: a copy of paddle_tpu/inference/mesh/controller.py, which imports no
JAX; its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

from ...observability.catalog import metric as _metric
from ...observability.recorder import get_recorder as _get_recorder
from ...resilience.faults import fault_point

__all__ = ["MeshController"]


class MeshController:
    """controller = MeshController(router, max_replicas=4)
    router.controller = controller     # acted on every pump
    """

    def __init__(self, router, min_replicas=1, max_replicas=4,
                 drain_rounds=50, spawn_role="auto"):
        self.router = router
        self.pool = router.pool
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.drain_rounds = max(1, int(drain_rounds))
        self.spawn_role = spawn_role
        self.enabled = True
        self.actions = {"scale_up": 0, "drain_begin": 0, "scale_down": 0,
                        "drain_forced": 0, "latch_off": 0}
        self._drain_waits: dict[str, int] = {}
        self._rec = _get_recorder()

    # --- accounting -------------------------------------------------------
    def _action(self, action, **detail):
        self.actions[action] += 1
        _metric("mesh_controller_actions_total", action=action).inc()
        if self._rec.enabled:
            self._rec.record("controller", action=action, **detail)

    # --- the acting loop --------------------------------------------------
    def act(self, verdict=None):
        """One controller tick from the router pump: progress any
        in-flight drain, then act on the verdict (None / hold = drains
        only). Latches to advisory-only on ANY failure."""
        if not self.enabled:
            return
        try:
            fault_point("mesh.controller_act",
                        action=None if verdict is None
                        else verdict.get("action"))
            self._pump_drains()
            if verdict is not None:
                self._act(verdict)
        except Exception as e:  # noqa: BLE001 — latch, never break serving
            self.enabled = False
            self.actions["latch_off"] += 1
            _metric("mesh_controller_actions_total",
                    action="latch_off").inc()
            _metric("serving_runtime_degradations_total",
                    what="controller_advisory").inc()
            if self._rec.enabled:
                self._rec.record("controller", action="latch_off",
                                 error=repr(e))

    def _act(self, verdict):
        action = verdict.get("action")
        alive = self.pool.alive()
        if action == "scale_up":
            if len(alive) >= self.max_replicas or self._drain_waits:
                return      # at ceiling, or mid-drain: do not flap
            role = self.spawn_role
            if role == "auto":
                role = "decode" if self.pool.disaggregate else "both"
            rep = self.pool.spawn(role=role)
            self._action("scale_up", replica=rep.name, role=rep.role)
        elif action == "scale_down":
            if len(alive) <= self.min_replicas or self._drain_waits:
                return      # at floor, or one drain at a time
            victim = self._pick_victim(alive)
            if victim is None:
                return      # no candidate keeps the role invariants
            victim.draining = True
            self._drain_waits[victim.name] = 0
            self._action("drain_begin", replica=victim.name,
                         load=victim.load())

    def _pick_victim(self, alive):
        """Least-loaded worker whose removal keeps the pool routable:
        in a disaggregated mesh at least one prefill-capable and one
        decode-capable worker must survive."""
        def survives(rep):
            rest = [r for r in alive if r is not rep]
            if not rest:
                return False
            if self.pool.disaggregate:
                return (any(r.can_prefill() for r in rest)
                        and any(r.can_decode() for r in rest))
            return True
        cands = [r for r in alive if survives(r)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.load(), r.name))

    def _drained(self, rep):
        """Idle = nothing queued/occupied/parked on the worker, nothing
        finished-but-unharvested, and no mesh-side stream still assigned
        to it (harvest runs before the controller in the pump, so this
        is a stable read)."""
        if rep.load() > 0 or rep.engine.finished:
            return False
        return not any(not m.done and m.replica == rep.name
                       for m in self.router._open.values())

    def _pump_drains(self):
        for name in list(self._drain_waits):
            rep = self.pool.by_name(name)
            if not rep.alive:       # died mid-drain: failover handled it
                del self._drain_waits[name]
                continue
            if self._drained(rep):
                del self._drain_waits[name]
                self.pool.retire(name)
                self._action("scale_down", replica=name)
                continue
            self._drain_waits[name] += 1
            if self._drain_waits[name] > self.drain_rounds:
                # the victim would not drain (stuck stream, slow decode
                # budget): force it through the drilled kill path — its
                # uncommitted streams re-prefill on survivors,
                # byte-identical
                del self._drain_waits[name]
                self._action("drain_forced", replica=name)
                self.router.kill_replica(name, why="drain_forced")

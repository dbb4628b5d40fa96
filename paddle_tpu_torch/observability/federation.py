"""Mesh federation for the observability plane: per-replica samplers
merged under a bounded ``replica`` label, plus one mesh-level sampler
over the process-wide registry.

In-process mesh replicas share ONE metrics registry, so mesh-wide
aggregates (finished totals, TTFT/TPOT histograms, slo gauges) already
federate for free — the mesh-level MetricsSampler scrapes them and
evaluates RECORDING_RULES with an ``alive_filter`` over the pool's
lease membership, so a killed replica's frozen ``mesh_replica_headroom``
gauge cannot poison headroom_min/headroom_sum. What does NOT federate
for free is per-replica state: each Replica therefore carries its own
MetricsSampler whose scrape source is a pseudo metrics-snapshot built
from ``Replica.snapshot()`` (replica_* gauges and counters below), so
counter→rate conversion and retention apply uniformly.

Cardinality discipline mirrors the serving engine's tenant-overflow
cap: the first ``max_replicas`` distinct replica names get their own
``replica`` label value, later joins collapse to ``"overflow"`` — a
join storm cannot blow up the merged series set.

Freeze semantics: ``tick()`` samples ONLY alive replicas. A killed
replica keeps its sampler and every point it ever recorded (the
postmortem evidence), but its series stop advancing — frozen, listed
under ``frozen`` in merged_doc()/summary() — and the alive_filter
drops it from mesh aggregates. A rejoin resumes sampling on the same
series.

Failure semantics: a replica sampler that fails degrades ITSELF (plane
off for that replica, counted); a collector-level failure degrades the
whole collector. Either way ``MeshCollector.degraded`` goes True and
serving is untouched — the same obs.sample contract as timeseries.py.

Port: a copy of `paddle_tpu/observability/federation.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

from .catalog import metric as _metric
from .timeseries import DEFAULT_RETENTION, MetricsSampler

__all__ = ["MeshCollector", "replica_scrape", "MAX_REPLICA_LABELS"]

MAX_REPLICA_LABELS = 16


def _gauge(name, value):
    return {"name": name, "type": "gauge", "help": "", "labelnames": (),
            "samples": [{"labels": {}, "value": float(value or 0.0)}]}


def _counter(name, value):
    return {"name": name, "type": "counter", "help": "", "labelnames": (),
            "samples": [{"labels": {}, "value": float(value or 0.0)}]}


def replica_scrape(rep):
    """Zero-arg scrape callable for one Replica: its snapshot() as a
    metrics-snapshot-format doc (gauges for point-in-time state,
    counters for cumulative accounting so the sampler rates them)."""
    def scrape():
        s = rep.snapshot()
        return {"format": 1, "metrics": [
            _gauge("replica_load", s.get("load")),
            _gauge("replica_predicted_service_seconds",
                   s.get("predicted_service_s")),
            _gauge("replica_alive", 1.0 if s.get("alive") else 0.0),
            _counter("replica_routed_total", s.get("routed")),
            _counter("replica_finished_total", s.get("finished")),
            _counter("replica_tokens_total", s.get("tokens")),
            _counter("replica_steps_total", s.get("steps")),
            _counter("replica_step_seconds_total", s.get("step_seconds")),
        ]}
    return scrape


class MeshCollector:
    """Router-side federation point: one sampler per alive replica plus
    a mesh-level registry sampler, ticked together from the router pump
    (deterministic — ``now`` defaults to an internal tick counter)."""

    def __init__(self, pool, retention=DEFAULT_RETENTION,
                 max_replicas=MAX_REPLICA_LABELS):
        self.pool = pool
        self.retention = max(1, int(retention))
        self.max_replicas = max(1, int(max_replicas))
        self.enabled = True
        self._degraded = False
        self._labels = {}   # replica name -> bounded label value
        self._reps = {}     # replica name -> Replica (ever attached)
        self.ticks = 0
        self._auto_tick = 0.0
        self.mesh_sampler = MetricsSampler(
            retention=self.retention,
            alive_filter=lambda: {r.name for r in pool.alive()})

    # --- label bounding (tenant-overflow discipline) ------------------

    def label_for(self, name):
        lab = self._labels.get(name)
        if lab is None:
            lab = (name if len(self._labels) < self.max_replicas
                   else "overflow")
            self._labels[name] = lab
        return lab

    # --- the pump tick -----------------------------------------------

    def tick(self, now=None):
        """Sample every ALIVE replica plus the mesh-level registry.
        Returns True when the tick landed; any failure degrades the
        collector (plane off, serving untouched) and returns False."""
        if not self.enabled:
            return False
        try:
            if now is None:
                now = self._auto_tick
            now = float(now)
            self._auto_tick = now + 1.0
            for rep in self.pool.alive():
                smp = getattr(rep, "sampler", None)
                if smp is None:
                    smp = MetricsSampler(scrape=replica_scrape(rep),
                                         retention=self.retention)
                    rep.sampler = smp
                self._reps[rep.name] = rep
                self.label_for(rep.name)
                smp.sample(now)
            self.mesh_sampler.sample(now)
            self.ticks += 1
            return True
        except Exception:
            self.enabled = False
            self._degraded = True
            try:
                _metric("obs_plane_degradations_total",
                        what="collector").inc()
            except Exception:
                pass
            return False

    # --- state --------------------------------------------------------

    @property
    def degraded(self):
        if self._degraded or self.mesh_sampler.degraded:
            return True
        return any(getattr(rep, "sampler", None) is not None
                   and rep.sampler.degraded
                   for rep in self._reps.values())

    def frozen(self):
        """Replica names with recorded series but a dead lease — their
        series no longer advance and mesh aggregates exclude them."""
        alive = {r.name for r in self.pool.alive()}
        return sorted(set(self._reps) - alive)

    def latest(self, rule):
        """Latest mesh-level value of a recording rule (or None)."""
        return self.mesh_sampler.rule_latest(rule)

    def replica_stats(self):
        """name -> Replica.snapshot() for every ever-attached replica
        (the advisor's drain-prediction input)."""
        return {name: rep.snapshot()
                for name, rep in sorted(self._reps.items())}

    def merged_doc(self):
        """Federated TSDB snapshot (format 1): every per-replica series
        tagged with its bounded ``replica`` label, mesh-level series
        untagged, plus membership (alive / frozen)."""
        series = []
        for name, rep in sorted(self._reps.items()):
            smp = getattr(rep, "sampler", None)
            if smp is None:
                continue
            lab = self.label_for(name)
            for row in smp.snapshot_doc()["series"]:
                row["labels"] = dict(row["labels"], replica=lab)
                series.append(row)
        series.extend(self.mesh_sampler.snapshot_doc()["series"])
        return {"format": 1, "replicas": sorted(self._reps),
                "alive": sorted(r.name for r in self.pool.alive()),
                "frozen": self.frozen(), "ticks": self.ticks,
                "series": series}

    def summary(self):
        """Plane-state summary for reports: the mesh sampler's rule
        summary plus membership and federation counters."""
        out = self.mesh_sampler.summary()
        out["replicas"] = sorted(self._reps)
        out["frozen"] = self.frozen()
        out["ticks"] = self.ticks
        out["degraded"] = self.degraded
        out["enabled"] = self.enabled
        out["replica_series"] = sum(
            len(rep.sampler.series) for rep in self._reps.values()
            if getattr(rep, "sampler", None) is not None)
        return out

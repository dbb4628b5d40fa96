"""Elastic membership manager. reference: paddle_tpu/distributed/fleet/
elastic.py, after fleet/elastic/manager.py:125 ElasticManager (a node
registry with leases and heartbeats :218-260, the membership watch :248,
restart on change).

The registry rides the port's TCPStore (distributed/store.py, built from
csrc/tcp_store.cc): the same lease, heartbeat and watch semantics as the
reference, store calls retried by resilience.RetryPolicy, and the fault
site `elastic.heartbeat`. The manager detects a membership change,
decides COMPLETED/HOLD/RESTART/EXIT, and calls the restart callback so
training resumes from the last checkpoint.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ...resilience.faults import fault_point
from ...resilience.retry import RetryPolicy

__all__ = ["ElasticStatus", "ElasticManager"]


def _count(name):
    """Recovery telemetry (observability catalog); never fails the
    recovery path over a metrics problem."""
    try:
        from ...observability.catalog import metric
        metric(name).inc()
    except Exception:  # noqa: BLE001
        pass


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """
    em = ElasticManager(store, node_id="host0", np_range=(2, 4),
                        heartbeat_interval=5, on_change=restart_fn)
    em.register()          # announce this node
    em.start()             # heartbeats + membership watch
    status = em.watch()    # blocks until change / completion
    """

    PREFIX = "__elastic/nodes/"

    def __init__(self, store, node_id=None, np_range=(1, 1),
                 heartbeat_interval=5.0, lease_ttl=None, on_change=None,
                 max_restart=3, retry_policy=None):
        self._store = store
        self.node_id = node_id or f"{os.uname().nodename}-{os.getpid()}"
        lo, hi = (np_range if isinstance(np_range, tuple)
                  else (np_range, np_range))
        self.np_lo, self.np_hi = int(lo), int(hi)
        self._hb_interval = float(heartbeat_interval)
        self._ttl = float(lease_ttl or heartbeat_interval * 3)
        self._on_change = on_change
        self.max_restart = max_restart
        self.restarts = 0
        self._stop = threading.Event()
        self._hb_thread = None
        self._registered = False
        # transient store faults recover inside the lease budget: total
        # retry time must stay well under the ttl so a surviving node's
        # lease never expires while the store blips
        self._retry = retry_policy or RetryPolicy(
            max_attempts=3, base_delay=min(0.05, self._hb_interval / 10),
            max_delay=self._hb_interval / 2, seed=0)
        self._retry_lock = threading.Lock()

    def _store_call(self, fn, *args, op, recovery_metric):
        """Retried store op shared by the heartbeat and membership-watch
        paths. Returns (ok, value); a recovery (success after >=1 retry)
        is counted so silent flakiness shows up in the catalog."""
        with self._retry_lock:
            out = self._retry.call(fn, *args, op=op)
            if self._retry.last_retries:
                _count(recovery_metric)
            return out

    # -- registry ------------------------------------------------------------
    def _key(self, node_id=None):
        return f"{self.PREFIX}{node_id or self.node_id}"

    def register(self):
        # race-free membership index: store.add atomically allocates a slot,
        # then the node id is written under that slot — concurrent registers
        # can never clobber each other (the read-modify-write of a shared
        # list would)
        slot = self._store.add("__elastic/nslots", 1)
        self._store.set(f"__elastic/slot/{slot}", self.node_id.encode())
        self._beat()
        self._registered = True

    def deregister(self):
        if self._registered:
            self.stop()  # the heartbeat thread must die BEFORE the tombstone
            self._store.set(self._key(), b"")  # tombstone: empty lease
            self._registered = False

    def _beat(self):
        fault_point("elastic.heartbeat", node=self.node_id)
        lease = json.dumps({"t": time.time(), "pid": os.getpid()}).encode()
        self._store.set(self._key(), lease)

    def _load_index(self):
        try:
            n = int(self._store_call(
                self._store.add, "__elastic/nslots", 0,
                op="elastic.watch", recovery_metric=
                "elastic_watch_recoveries_total"))
        except Exception:  # noqa: BLE001 — store down past the retry
            return []      # budget: treat as empty, next poll retries
        seen, members = set(), []
        for slot in range(1, n + 1):
            key = f"__elastic/slot/{slot}"
            try:
                # check() first: get() blocks up to the store timeout on a
                # missing key (e.g. a node died between slot allocation and
                # the slot write), which would freeze every membership poll
                if not self._store_call(
                        self._store.check, key, op="elastic.watch",
                        recovery_metric="elastic_watch_recoveries_total"):
                    continue
                nid = self._store_call(
                    self._store.get, key, op="elastic.watch",
                    recovery_metric="elastic_watch_recoveries_total"
                ).decode()
            except Exception:  # noqa: BLE001
                continue
            if nid and nid not in seen:
                seen.add(nid)
                members.append(nid)
        return members

    def alive_nodes(self):
        """Nodes whose lease is fresh (within ttl)."""
        now = time.time()
        alive = []
        for nid in self._load_index():
            try:
                if not self._store_call(
                        self._store.check, self._key(nid),
                        op="elastic.watch", recovery_metric=
                        "elastic_watch_recoveries_total"):
                    continue
                raw = self._store_call(
                    self._store.get, self._key(nid), op="elastic.watch",
                    recovery_metric="elastic_watch_recoveries_total")
            except Exception:  # noqa: BLE001
                continue
            if not raw:
                continue  # tombstone
            try:
                lease = json.loads(raw.decode())
            except ValueError:
                continue
            if now - lease["t"] <= self._ttl:
                alive.append(nid)
        return alive

    # -- heartbeat loop ------------------------------------------------------
    def start(self):
        if self._hb_thread is None:
            self._stop.clear()
            self._hb_thread = threading.Thread(target=self._hb_loop,
                                               daemon=True, name="elastic-hb")
            self._hb_thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=self._hb_interval * 2)
            self._hb_thread = None

    def _hb_loop(self):
        while not self._stop.wait(self._hb_interval):
            try:
                self._store_call(
                    self._beat, op="elastic.heartbeat",
                    recovery_metric="elastic_heartbeat_recoveries_total")
            except Exception:  # noqa: BLE001 — store down past the retry
                # budget: keep beating, the lease may survive — counted,
                # never raised into the owning replica's serving loop
                _count("elastic_beat_failures_total")

    # -- membership decisions ------------------------------------------------
    def health(self):
        n = len(self.alive_nodes())
        if n < self.np_lo:
            return ElasticStatus.HOLD       # not enough nodes to run
        if n > self.np_hi:
            return ElasticStatus.ERROR      # over-subscribed (config bug)
        return ElasticStatus.COMPLETED

    def watch(self, poll=None, max_wait=None):
        """Block until membership changes from the current set (or timeout).
        Returns RESTART on change (train must re-init the mesh), HOLD if
        below np_lo, EXIT when max_restart exhausted."""
        poll = poll or self._hb_interval
        baseline = set(self.alive_nodes())
        deadline = time.time() + max_wait if max_wait else None
        while not self._stop.is_set():
            time.sleep(poll)
            cur = set(self.alive_nodes())
            if cur != baseline:
                _count("elastic_membership_changes_total")
                if len(cur) < self.np_lo:
                    return ElasticStatus.HOLD
                self.restarts += 1
                if self.restarts > self.max_restart:
                    return ElasticStatus.EXIT
                if self._on_change is not None:
                    self._on_change(sorted(cur))
                _count("elastic_restarts_total")
                return ElasticStatus.RESTART
            if deadline and time.time() > deadline:
                return ElasticStatus.COMPLETED
        return ElasticStatus.COMPLETED

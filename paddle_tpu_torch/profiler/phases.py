"""Per-phase engine wall-time accountant over a CLOSED phase registry.

"Where did the milliseconds go": the serving engine calls
``begin_step()`` at the top of each ``step()``, ``mark(phase)`` at every
phase boundary it crosses, and ``end_step()`` at the bottom. Each mark
attributes the wall time since the previous mark to one registered
phase, so the phases PARTITION the step — attribution coverage
(attributed / measured wall) is structural, not sampled, and the
harness asserts it stays >= 95%.

Catalog discipline (same as FAULT_SITES / EVENT_KINDS): ``PHASES`` is
the closed set; marking an unknown phase raises, ``tools/static_check.py``
pins every phase literal in ``profiler/`` and ``serving.py`` to this
dict, and OBSERVABILITY.md documents each row (both directions).

Disabled-mode contract (same as the flight recorder): every mutation
starts with one attribute check and returns before allocating, so a
disabled accountant costs one branch per call site. Call sites that
would build kwargs guard with ``if acct.enabled:`` themselves.

Port: a copy of `paddle_tpu/profiler/phases.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["PHASES", "PhaseAccountant", "get_phase_accountant"]

# The closed set of engine phases. One row per phase in
# OBSERVABILITY.md's phase registry; serving.py may mark() only these.
PHASES = {
    "admit": "deadline sweep + queue admission: lane assignment and "
             "paged-KV reservation for queued requests",
    "prefill.chunk": "one chunked-prefill program call (warm path), "
                     "including argument staging",
    "decode.dispatch": "building lane operands and launching one fused "
                       "K-step decode tile (async dispatch)",
    "decode.readback": "drained-tile bookkeeping around the host sync: "
                       "retire checks, trace emission, tile accounting",
    "hostsync": "host blocked on device->host readback of a decode "
                "token tile (the np.asarray wait)",
    "lane_upload": "rebuilding + uploading device lane state after a "
                   "membership change (admit/retire/shed)",
    "commit": "crediting sampled tokens to streams: emit callbacks, "
              "EOS/length finish checks",
    "compile": "cold-path program construction: pir_jit build + first "
               "trace/compile of a decode or prefill variant",
}


class PhaseAccountant:
    """Mark-based timeline splitter: consecutive ``mark()`` calls split
    the step's wall clock into phase-attributed segments."""

    __slots__ = ("enabled", "_lock", "_t_step", "_last", "_wall", "_attr",
                 "_phase_s", "_phase_n", "_tenant_s", "_steps", "_hist",
                 "_cov")

    def __init__(self, enabled=False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._hist = None       # phase -> bound catalog histogram child
        self._cov = None        # bound coverage gauge
        self._zero()

    def _zero(self):
        self._t_step = None     # perf_counter at begin_step
        self._last = None       # perf_counter at the previous mark
        self._wall = 0.0        # sum of measured step wall time
        self._attr = 0.0        # sum of phase-attributed time
        self._phase_s = {p: 0.0 for p in PHASES}
        self._phase_n = {p: 0 for p in PHASES}
        self._tenant_s = {}     # tenant -> attributed seconds
        self._steps = 0

    def _bind(self):
        # lazy so a disabled accountant never imports the catalog
        from ..observability.catalog import metric
        self._hist = {p: metric("serving_phase_seconds", phase=p)
                      for p in PHASES}
        self._cov = metric("serving_phase_coverage_ratio")

    # -- lifecycle -----------------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        with self._lock:
            self._zero()

    # -- accounting ----------------------------------------------------------
    def begin_step(self):
        if not self.enabled:
            return
        self._t_step = self._last = time.perf_counter()

    def mark(self, phase, tenant=None, dt=None):
        """Attribute wall time since the previous mark (or ``dt`` seconds
        carved out of the current segment) to `phase`; unknown phases
        raise (closed registry). `tenant` additionally credits the
        in-memory per-tenant split."""
        if not self.enabled:
            return
        if phase not in PHASES:
            raise KeyError(f"unknown profiler phase {phase!r}; registered "
                           f"phases: {sorted(PHASES)}")
        if self._last is None:      # mark outside begin_step: ignore
            return
        if self._hist is None:
            self._bind()
        now = time.perf_counter()
        seg = now - self._last if dt is None else min(dt, now - self._last)
        self._last = now
        with self._lock:
            self._attr += seg
            self._phase_s[phase] += seg
            self._phase_n[phase] += 1
            if tenant is not None:
                self._tenant_s[tenant] = self._tenant_s.get(tenant, 0.0) + seg
        self._hist[phase].observe(seg)

    def end_step(self):
        if not self.enabled:
            return
        if self._t_step is None:
            return
        now = time.perf_counter()
        with self._lock:
            self._wall += now - self._t_step
            self._steps += 1
            cov = self._attr / self._wall if self._wall > 0 else 0.0
        self._t_step = self._last = None
        if self._cov is not None:
            self._cov.set(cov)

    def credit_tenants(self, tenants, seconds):
        """Split `seconds` of already-attributed shared time (one decode
        tile serves many lanes) evenly across `tenants` for the
        per-tenant report."""
        if not self.enabled:
            return
        if not tenants:
            return
        share = seconds / len(tenants)
        with self._lock:
            for t in tenants:
                self._tenant_s[t] = self._tenant_s.get(t, 0.0) + share

    # -- reporting -----------------------------------------------------------
    @property
    def coverage(self):
        with self._lock:
            return self._attr / self._wall if self._wall > 0 else 0.0

    def report(self):
        """Machine-readable accounting: measured wall, attributed time,
        coverage ratio, per-phase seconds/counts, per-tenant seconds."""
        with self._lock:
            return {
                "steps": self._steps,
                "wall_s": self._wall,
                "attributed_s": self._attr,
                "coverage": (self._attr / self._wall
                             if self._wall > 0 else 0.0),
                "phases": {p: {"seconds": self._phase_s[p],
                               "marks": self._phase_n[p]}
                           for p in PHASES if self._phase_n[p]},
                "tenants": dict(sorted(self._tenant_s.items())),
            }


_default_accountant: PhaseAccountant | None = None
_default_lock = threading.Lock()


def get_phase_accountant() -> PhaseAccountant:
    """Process-wide accountant (recorder idiom): disabled unless
    FLAGS_observability is truthy in the env; tests and the loadgen
    harness enable()/reset() it explicitly."""
    global _default_accountant
    if _default_accountant is None:
        with _default_lock:
            if _default_accountant is None:
                _default_accountant = PhaseAccountant(
                    enabled=os.environ.get("FLAGS_observability", "")
                    .lower() in ("1", "true", "yes", "on"))
    return _default_accountant

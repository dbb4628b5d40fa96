"""Failure handling. reference: paddle_tpu/resilience/__init__.py.

Two of the reference's three pieces are ported:

* `faults` — the deterministic fault-injection harness over a closed
  registry of named sites (`FLAGS_fault_injection`, or `arm()`/
  `injected_faults(...)` in tests); disarmed it costs one global load
  per site. The serving engine calls its `serve.*` sites.
* `retry` — `RetryPolicy` (jittered exponential backoff + attempt
  budget + deadline) and `CircuitBreaker`.

The third, `supervisor` (`TrainSupervisor`), waits for the training
supervisor work (ROADMAP.md).
"""

from __future__ import annotations

from . import faults, retry  # noqa: F401
from .faults import (  # noqa: F401
    FAULT_SITES, FaultInjected, FaultSpec, arm, arm_spec, check, disarm,
    fault_point, injected_faults)
from .retry import (  # noqa: F401
    DEFAULT_TRANSIENT, CircuitBreaker, CircuitOpenError, RetryPolicy)

__all__ = ["faults", "retry", "FAULT_SITES", "FaultSpec", "FaultInjected",
           "fault_point", "check", "arm", "arm_spec", "disarm",
           "injected_faults", "RetryPolicy", "CircuitBreaker",
           "CircuitOpenError", "DEFAULT_TRANSIENT"]

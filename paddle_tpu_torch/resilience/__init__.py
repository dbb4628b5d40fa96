"""Failure handling. reference: paddle_tpu/resilience/__init__.py.

* `faults` — the deterministic fault-injection harness over a closed
  registry of named sites (`FLAGS_fault_injection`, or `arm()`/
  `injected_faults(...)` in tests); disarmed it costs one global load
  per site. The serving engine calls its `serve.*` sites.
* `retry` — `RetryPolicy` (jittered exponential backoff + attempt
  budget + deadline) and `CircuitBreaker`.
* `supervisor` — `TrainSupervisor` around a training step: non-finite
  loss skip, SIGTERM preemption grace (a final checkpoint and a clean
  exit) and checkpoint auto-resume.
"""

from __future__ import annotations

from . import faults, retry, supervisor  # noqa: F401
from .faults import (  # noqa: F401
    FAULT_SITES, FaultInjected, FaultSpec, arm, arm_spec, check, disarm,
    fault_point, injected_faults)
from .retry import (  # noqa: F401
    DEFAULT_TRANSIENT, CircuitBreaker, CircuitOpenError, RetryPolicy)
from .supervisor import (  # noqa: F401
    NonFiniteLossError, Preempted, TrainSupervisor)

__all__ = ["faults", "retry", "supervisor", "FAULT_SITES", "FaultSpec",
           "FaultInjected", "fault_point", "check", "arm", "arm_spec", "disarm",
           "injected_faults", "RetryPolicy", "CircuitBreaker",
           "CircuitOpenError", "DEFAULT_TRANSIENT", "TrainSupervisor",
           "NonFiniteLossError", "Preempted"]

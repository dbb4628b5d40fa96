"""Profiler. reference: paddle_tpu/profiler/__init__.py.

Only the per-phase wall-time accountant is ported (`phases.py`, which the
serving engine marks). The reference's `Profiler`, `RecordEvent` and trace
export wrap `jax.profiler`, and their torch counterparts are not ported.
"""

from __future__ import annotations

from .phases import PHASES, PhaseAccountant, get_phase_accountant

__all__ = ["PHASES", "PhaseAccountant", "get_phase_accountant"]

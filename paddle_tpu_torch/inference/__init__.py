"""Inference. reference: paddle_tpu/inference/__init__.py.

The continuous-batching serving engine over the paged KV pool is ported
(`serving.py`). The reference's `Config`/`Predictor`, load generation,
adapters, scheduler, prefix cache and mesh are not yet (ROADMAP.md).
"""

from .serving import (BackpressureError, ContinuousBatchingEngine,
                      KVPoolExhaustedError, Request)

__all__ = ["ContinuousBatchingEngine", "Request", "BackpressureError",
           "KVPoolExhaustedError"]

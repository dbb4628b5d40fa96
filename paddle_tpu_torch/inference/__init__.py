"""Inference. reference: paddle_tpu/inference/__init__.py.

The continuous-batching serving engine over the paged KV pool
(`serving.py`) with its knobs: speculative decode (`drafting.py`), LoRA
adapters (`adapters.py`), the SLO scheduler (`scheduler.py`) and the
prefix cache (`prefix_cache.py`). The reference's `Config`/`Predictor`,
load generation and the serving mesh are not ported yet (ROADMAP.md).
"""

from .adapters import (AdapterLoadError, AdapterStore, LoraWeights,
                       demo_store_for_engine, make_demo_store,
                       per_adapter_slos)
from .scheduler import BROWNOUT_LEVELS, PRIORITY_CLASSES, SLOScheduler
from .serving import (BackpressureError, ContinuousBatchingEngine,
                      KVPoolExhaustedError, Request)

__all__ = ["ContinuousBatchingEngine", "Request", "BackpressureError",
           "KVPoolExhaustedError",
           "AdapterStore", "AdapterLoadError", "LoraWeights",
           "make_demo_store", "demo_store_for_engine", "per_adapter_slos",
           "SLOScheduler", "PRIORITY_CLASSES", "BROWNOUT_LEVELS"]

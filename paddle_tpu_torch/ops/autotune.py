"""Runtime kernel autotuning: time candidate configurations, cache the
winner. reference: paddle_tpu/ops/pallas/autotune.py (`AlgorithmCache`,
`autotune`, the switch `FLAGS_use_autotune`, `autotune_status`).

`autotune(key, candidates, make_runner)` times each candidate once per key
(best of `repeats` after a warm-up, the device synchronised around each
run), skips a candidate whose runner raises, and caches the fastest.
Off by default, as the reference's switch is. The flash wrapper does not
ask it yet: the port's kernels are compiled for one tile (128 x 128) at
each head dim (`ops/flash_attention.TILE_CANDIDATES`), so there is
nothing to choose among.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

from ..framework import flags as _flags

__all__ = ["AlgorithmCache", "autotune", "enable_autotune",
           "disable_autotune", "autotune_enabled", "autotune_status"]

_flags.define_flag(
    "use_autotune", False,
    "time candidate kernel configurations on first use and cache the "
    "winner")

# each key's candidate -> ms from its most recent tuning run
timing_log: dict = {}


class AlgorithmCache:
    """The winners and the cache's hits and misses."""

    def __init__(self):
        self._cache: dict[Any, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        return None

    def put(self, key, value):
        self._cache[key] = value

    def clear(self):
        self._cache.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._cache)


_global_cache = AlgorithmCache()


def enable_autotune():
    _flags.set_flags({"use_autotune": True})


def disable_autotune():
    _flags.set_flags({"use_autotune": False})


def autotune_enabled() -> bool:
    return bool(_flags.flag_value("use_autotune"))


def autotune_status():
    return {"enabled": autotune_enabled(), "size": len(_global_cache),
            "cache_hits": _global_cache.hits,
            "cache_misses": _global_cache.misses}


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _time_once(fn: Callable[[], Any], repeats: int = 2) -> float:
    """The best wall time of fn() over `repeats` runs after a warm-up."""
    fn()
    _sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune(key, candidates: Sequence[Any], make_runner, default=None,
             repeats: int = 2):
    """The fastest of `candidates` for `key`, cached.

    make_runner(candidate) gives a zero-argument callable that runs the
    kernel with that configuration, or raises to rule the candidate out.
    With tuning off, or every candidate ruled out, `default` (else the
    first candidate)."""
    if default is None:
        default = candidates[0]
    if not autotune_enabled():
        return default
    cached = _global_cache.get(key)
    if cached is not None:
        return cached
    best, best_t = default, float("inf")
    timings = {}
    for cand in candidates:
        try:
            t = _time_once(make_runner(cand), repeats)
        except Exception:
            continue            # not runnable at this shape or device
        timings[str(cand)] = round(t * 1e3, 3)
        if t < best_t:
            best, best_t = cand, t
    _global_cache.put(key, best)
    timing_log[key] = timings
    return best


def clear_cache():
    _global_cache.clear()

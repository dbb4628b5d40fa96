"""Retry policies and circuit breaking for transient runtime faults.

A `RetryPolicy` is jittered exponential backoff with an attempt budget
and an optional wall-clock deadline; a `CircuitBreaker` stops hammering
a dependency that keeps failing and lets it recover. Both are pure-host
stdlib objects applied to the failure-prone seams: TCPStore ops,
checkpoint IO, and the elastic heartbeat/membership watch.

Determinism: jitter comes from a `random.Random(seed)` stream, so a
seeded policy produces the same backoff sequence every run — chaos
drills stay reproducible. Retries and give-ups are counted in the
observability catalog per `op` label (`resilience_retries_total`,
`resilience_retry_giveups_total`, `resilience_circuit_open_total`).

Port: a copy of `paddle_tpu/resilience/retry.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

import random
import time

__all__ = ["RetryPolicy", "CircuitBreaker", "CircuitOpenError",
           "DEFAULT_TRANSIENT"]

# what "transient" means by default: timeouts, connection blips, and IO
# errors. Anything else (ValueError, RuntimeError, ...) is a logic error
# and must escape immediately.
DEFAULT_TRANSIENT = (TimeoutError, ConnectionError, OSError)


def _count(name, **labels):
    try:
        from ..observability.catalog import metric
        metric(name, **labels).inc()
    except Exception:  # noqa: BLE001 — never fail the op over metrics
        pass


class RetryPolicy:
    """
    policy = RetryPolicy(max_attempts=4, base_delay=0.05, deadline=10)
    value = policy.call(store.get, key, op="store.get")
    """

    def __init__(self, max_attempts=4, base_delay=0.05, max_delay=2.0,
                 deadline=None, jitter=0.5, retry_on=DEFAULT_TRANSIENT,
                 seed=None, sleep=time.sleep, clock=time.monotonic,
                 on_retry=None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = None if deadline is None else float(deadline)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        self._on_retry = on_retry

    def backoff(self, attempt):
        """Delay before retry number `attempt` (1-based): exponential,
        capped, multiplied into [1-jitter, 1] deterministically from the
        seeded stream."""
        d = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def call(self, fn, *args, op="op", **kwargs):
        """Run fn(*args, **kwargs); retry transient failures with
        backoff until the attempt budget or deadline runs out, then
        re-raise the last exception. Returns (on success) fn's value;
        `.last_retries` holds the retry count of the most recent call."""
        start = self._clock()
        self.last_retries = 0
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if attempt >= self.max_attempts:
                    _count("resilience_retry_giveups_total", op=op)
                    raise
                delay = self.backoff(attempt)
                if (self.deadline is not None
                        and self._clock() - start + delay > self.deadline):
                    _count("resilience_retry_giveups_total", op=op)
                    raise
                _count("resilience_retries_total", op=op)
                self.last_retries += 1
                if self._on_retry is not None:
                    self._on_retry(op, attempt, e)
                self._sleep(delay)

    def wrap(self, op):
        """Decorator form: @policy.wrap("ckpt.chunk_write")."""
        def deco(fn):
            def inner(*args, **kwargs):
                return self.call(fn, *args, op=op, **kwargs)
            inner.__name__ = getattr(fn, "__name__", op)
            return inner
        return deco


class CircuitOpenError(RuntimeError):
    """Raised instead of calling through while the breaker is open."""


class CircuitBreaker:
    """Classic three-state breaker: CLOSED counts consecutive failures;
    at `failure_threshold` it OPENs (calls fail fast with
    CircuitOpenError) for `reset_timeout` seconds; then one HALF_OPEN
    probe call decides — success closes, failure re-opens."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold=5, reset_timeout=30.0,
                 clock=time.monotonic, op="op"):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self.op = op
        self.state = self.CLOSED
        self.failures = 0
        self._opened_at = None

    def _tick(self):
        if (self.state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self.state = self.HALF_OPEN

    def allow(self):
        self._tick()
        return self.state != self.OPEN

    def record_success(self):
        self.state = self.CLOSED
        self.failures = 0

    def record_failure(self):
        self.failures += 1
        if (self.state == self.HALF_OPEN
                or self.failures >= self.failure_threshold):
            if self.state != self.OPEN:
                _count("resilience_circuit_open_total", op=self.op)
            self.state = self.OPEN
            self._opened_at = self._clock()

    def call(self, fn, *args, **kwargs):
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.op!r} open after {self.failures} "
                f"consecutive failures; retrying after "
                f"{self.reset_timeout}s")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out

"""Hang detection for training steps. reference:
paddle_tpu/distributed/watchdog.py (`Watchdog` :26, `enable_comm_watchdog`
:139), after paddle/phi/core/distributed/comm_task_manager.h:37.

A step that never completes (a dead peer, a hung collective, a data
stall) is what hangs a job, so the watchdog guards steps: a background
thread fires when the time since the last step completion (or the start
of the current step) exceeds the timeout, writes every Python thread's
stack to stderr and then, as `on_timeout` says, stops there ("dump"),
calls a callable with the watchdog, or aborts the process with exit code
124 ("abort") so a launcher can restart it from its last checkpoint.
"""
from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
import traceback

__all__ = ["Watchdog", "enable_comm_watchdog"]


class Watchdog:
    """Step-liveness watchdog.

    wd = Watchdog(timeout=300, on_timeout="dump")  # or "abort" / callable
    for batch in loader:
        with wd.step_guard():
            train_step(batch)
    """

    def __init__(self, timeout=600.0, on_timeout="dump", poll_interval=None,
                 name="train"):
        self.timeout = float(timeout)
        self.on_timeout = on_timeout
        self.name = name
        self._poll = poll_interval or max(1.0, self.timeout / 10)
        self._last_beat = None
        self._in_step_since = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._fired = False
        self._thread = None
        self._step_count = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._last_beat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"watchdog-{self.name}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll * 2)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- step accounting -----------------------------------------------------
    def beat(self):
        """Mark liveness (a step completed)."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._in_step_since = None
            self._step_count += 1

    class _StepGuard:
        def __init__(self, wd):
            self._wd = wd

        def __enter__(self):
            with self._wd._lock:
                self._wd._in_step_since = time.monotonic()
            return self

        def __exit__(self, *exc):
            self._wd.beat()

    def step_guard(self):
        if self._thread is None:
            self.start()
        return Watchdog._StepGuard(self)

    @property
    def step_count(self):
        return self._step_count

    @property
    def fired(self):
        return self._fired

    # -- detection -----------------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self._poll):
            with self._lock:
                ref = self._in_step_since or self._last_beat
            if ref is None:
                continue
            gap = time.monotonic() - ref
            if gap > self.timeout:
                self._fired = True
                self._fire(gap)
                return

    def _fire(self, gap):
        msg = (f"[watchdog:{self.name}] no step completion for {gap:.0f}s "
               f"(timeout {self.timeout:.0f}s, {self._step_count} steps done) "
               f"— likely hung collective / dead peer / data stall")
        sys.stderr.write(msg + "\n")
        # dump all thread stacks — the analog of the reference's comm-task
        # diagnostics (comm_task_manager.cc timeout logs)
        for tid, frame in sys._current_frames().items():
            sys.stderr.write(f"--- thread {tid} ---\n")
            sys.stderr.write("".join(traceback.format_stack(frame)))
        sys.stderr.flush()
        if callable(self.on_timeout):
            self.on_timeout(self)
        elif self.on_timeout == "abort":
            faulthandler.dump_traceback()
            os._exit(124)  # noqa: SLF001 — deliberate hard abort for restart


_global_watchdog = None


def enable_comm_watchdog(timeout=None, on_timeout="dump"):
    """Process-wide watchdog, reading the reference's env knobs
    (FLAGS_pg_timeout analog: PADDLE_WATCHDOG_TIMEOUT seconds)."""
    global _global_watchdog
    if timeout is None:
        timeout = float(os.environ.get("PADDLE_WATCHDOG_TIMEOUT", "600"))
    if _global_watchdog is None:
        _global_watchdog = Watchdog(timeout=timeout, on_timeout=on_timeout,
                                    name="global").start()
    return _global_watchdog

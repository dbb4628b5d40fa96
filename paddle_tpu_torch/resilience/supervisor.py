"""The training supervisor: non-finite-loss skip, preemption grace,
checkpoint cadence and auto-resume. reference:
paddle_tpu/resilience/supervisor.py (`NonFiniteLossError` :43,
`Preempted` :48, `TrainSupervisor` :61).

Wraps any step callable (`LlamaPipeRunner.step`, `SpmdTrainer.step`, a
closure):

* non-finite loss: the batch is skipped (counted in
  `train_nonfinite_skips_total`), `restore_fn` rolls back to the last
  checkpoint where given, and only a streak of more than
  `max_consecutive_nonfinite` raises NonFiniteLossError;
* preemption: SIGTERM (or `request_preemption()`) sets a flag; at the next
  step boundary the supervisor calls `save_fn` and raises Preempted, a
  SystemExit with code 0;
* auto-resume: `resume()` reloads through `load_fn` and restores the step
  counter.

The fault site `train.step_nonfinite` (resilience/faults.py) forces the
non-finite path without touching the model.
"""
from __future__ import annotations

import math
import signal as _signal
import threading

from . import faults

__all__ = ["TrainSupervisor", "NonFiniteLossError", "Preempted"]


def _count(name):
    try:
        from ..observability.catalog import metric
        metric(name).inc()
    except Exception:  # noqa: BLE001 — supervision never fails over metrics
        pass


class NonFiniteLossError(RuntimeError):
    """Too many consecutive non-finite losses: the run is diverging, not
    hitting a transient batch — stop instead of burning the job."""


class Preempted(SystemExit):
    """Raised at the step boundary after a preemption signal, AFTER the
    final checkpoint is written. Subclasses SystemExit(0): if the train
    script does not catch it, the process still exits cleanly."""

    def __init__(self, step):
        super().__init__(0)
        self.step = step

    def __str__(self):
        return f"preempted at step {self.step} (final checkpoint written)"


class TrainSupervisor:
    """
    sup = TrainSupervisor(trainer.step,
                          save_fn=lambda step: save_ckpt(step),
                          load_fn=load_ckpt,          # -> start step or None
                          checkpoint_every=10)
    sup.install_signal_handlers()                      # SIGTERM grace
    start = sup.resume()
    for s in range(start, total):
        loss = sup.step(batch)                         # None = skipped batch
    """

    def __init__(self, step_fn, save_fn=None, load_fn=None, restore_fn=None,
                 checkpoint_every=0, max_consecutive_nonfinite=3):
        self._step_fn = step_fn
        self._save_fn = save_fn
        self._load_fn = load_fn
        self._restore_fn = restore_fn
        self.checkpoint_every = int(checkpoint_every)
        self.max_consecutive_nonfinite = int(max_consecutive_nonfinite)
        self.step_count = 0
        self.nonfinite_skips = 0
        self._consecutive_nonfinite = 0
        self._preempt = threading.Event()
        self._old_handlers = {}

    # -- preemption --------------------------------------------------------
    def install_signal_handlers(self, signals=(_signal.SIGTERM,)):
        """Register the grace-window handler (main thread only — the
        caller decides; workers under a launcher usually want this)."""
        for sig in signals:
            self._old_handlers[sig] = _signal.signal(
                sig, lambda *_: self._preempt.set())
        return self

    def restore_signal_handlers(self):
        for sig, old in self._old_handlers.items():
            _signal.signal(sig, old)
        self._old_handlers.clear()

    def request_preemption(self):
        """What the signal handler does — callable directly by tests and
        by platform-specific preemption notices (e.g. a metadata-server
        watcher thread)."""
        self._preempt.set()

    @property
    def preemption_requested(self):
        return self._preempt.is_set()

    def _finalize_preemption(self):
        if self._save_fn is not None:
            self._save_fn(self.step_count)
        _count("train_preemptions_total")
        try:
            from ..observability.recorder import get_recorder
            rec = get_recorder()
            if rec.enabled:
                rec.record("preempt", step=self.step_count)
                rec.dump(reason="preempt")
        except Exception:  # noqa: BLE001 — the black box never blocks exit
            pass
        raise Preempted(self.step_count)

    # -- resume ------------------------------------------------------------
    def resume(self):
        """Load the last complete checkpoint (if any) via load_fn; set
        and return the step to continue from. load_fn returning None
        means 'nothing to resume' (fresh start at 0)."""
        start = 0
        if self._load_fn is not None:
            loaded = self._load_fn()
            if loaded is not None:
                start = int(loaded)
        self.step_count = start
        return start

    # -- the supervised step ----------------------------------------------
    def step(self, *batch, **kwargs):
        """One supervised step. Returns the float loss, or None when the
        batch was skipped for a non-finite loss. Raises Preempted at the
        first step boundary after a preemption request (final checkpoint
        already written), NonFiniteLossError on a divergence streak."""
        if self._preempt.is_set():
            self._finalize_preemption()
        loss = self._step_fn(*batch, **kwargs)
        val = float(loss)
        if faults.check("train.step_nonfinite"):
            val = float("nan")
        if not math.isfinite(val):
            self.nonfinite_skips += 1
            self._consecutive_nonfinite += 1
            _count("train_nonfinite_skips_total")
            if self._restore_fn is not None:
                # roll back to the last good checkpoint so a poisoned
                # update cannot propagate
                self._restore_fn()
            if self._consecutive_nonfinite > self.max_consecutive_nonfinite:
                raise NonFiniteLossError(
                    f"{self._consecutive_nonfinite} consecutive non-finite "
                    f"losses at step {self.step_count} (limit "
                    f"{self.max_consecutive_nonfinite}): diverged")
            return None
        self._consecutive_nonfinite = 0
        self.step_count += 1
        if (self.checkpoint_every and self._save_fn is not None
                and self.step_count % self.checkpoint_every == 0):
            self._save_fn(self.step_count)
        return val

    def run(self, batches, total_steps=None):
        """Drive `step` over an iterable of batches (each an args tuple
        for step_fn); returns the list of recorded (finite) losses.
        Stops after total_steps successful steps when given."""
        losses = []
        target = None if total_steps is None else int(total_steps)
        for batch in batches:
            if target is not None and self.step_count >= target:
                break
            loss = self.step(*batch if isinstance(batch, tuple) else (batch,))
            if loss is not None:
                losses.append(loss)
        return losses

"""hapi callbacks. A copy of paddle_tpu/hapi/callbacks.py (:12-164;
reference: python/paddle/hapi/callbacks.py): ProgBarLogger prints,
ModelCheckpoint saves `save_dir/<epoch>` and `save_dir/final`,
EarlyStopping sets `model.stop_training` from the monitored value of
`on_eval_end`'s logs, and LRScheduler steps the optimizer's scheduler
each batch (or each epoch)."""

from __future__ import annotations

import os
import time

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "CallbackList"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()
        if self.verbose:
            total = self.params.get("epochs") if hasattr(self, "params") else "?"
            print(f"Epoch {epoch + 1}/{total}")

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and self.steps % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"step {self.steps}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {epoch + 1} done in {dt:.1f}s - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode

    def on_eval_end(self, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        if isinstance(v, (list, tuple)):
            v = v[0]
        better = (self.best is None or
                  (v < self.best - self.min_delta if self.mode == "min"
                   else v > self.best + self.min_delta))
        if better:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()

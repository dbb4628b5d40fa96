"""hapi.Model: high-level train/eval/predict. reference:
paddle_tpu/hapi/model.py (:20-242; python/paddle/hapi/model.py Model:1472,
fit:2200).

The network's device decides where the batches go: the loader's host
batches are moved to the device of the network's first parameter.
`train_batch` reads the loss back as a float every batch, as the
reference's does. With `amp_configs` ("O1", "O2" or a dict with `level`,
`init_loss_scaling`, `use_loss_scaling`, `use_dynamic_loss_scaling`),
`train_batch` runs the forward and the loss under `amp.auto_cast` (bfloat16)
and steps through a `GradScaler`, whose `update` it calls once more after
`step` (which calls it too), as the reference's does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..framework.io_file import load as _load, save as _save
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model", "summary"]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics else [])
        self._amp_level = None
        self._scaler = None
        if amp_configs:
            cfg = ({"level": amp_configs} if isinstance(amp_configs, str)
                   else dict(amp_configs))
            level = cfg.get("level", "O1")
            if level not in ("O0", "O1", "O2"):
                raise ValueError(f"amp level must be O0/O1/O2, got {level}")
            if level != "O0":
                self._amp_level = level
                from ..amp import GradScaler
                self._scaler = GradScaler(
                    enable=cfg.get("use_loss_scaling", True),
                    init_loss_scaling=cfg.get("init_loss_scaling", 2.0 ** 16),
                    use_dynamic_loss_scaling=cfg.get(
                        "use_dynamic_loss_scaling", True))

    # -- device ----------------------------------------------------------
    def _device(self):
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return torch.device("cpu")

    def _to_device(self, x):
        dev = self._device()
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(dev)
        if isinstance(x, (list, tuple)):
            return type(x)(self._to_device(v) for v in x)
        return x

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            return outputs
        if isinstance(labels, (list, tuple)):
            return self._loss(outputs, *labels)
        return self._loss(outputs, labels)

    # -- batches ---------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        inputs, labels = self._to_device(list(inputs)), \
            self._to_device(labels)
        if self._amp_level is not None:
            from ..amp import auto_cast
            with auto_cast(level=self._amp_level):
                outputs = self.network(*inputs)
                loss = self._compute_loss(outputs, labels)
            self._scaler.scale(loss).backward()
            if update:
                self._scaler.step(self._optimizer)
                self._scaler.update()
                self._optimizer.clear_grad()
        else:
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = [float(loss.detach())]
        for m in self._metrics:
            m.update(m.compute(outputs, labels))
        return metrics

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        inputs, labels = self._to_device(list(inputs)), \
            self._to_device(labels)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        for m in self._metrics:
            m.update(m.compute(outputs, labels))
        return [float(loss)]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self.network(*self._to_device(list(inputs)))

    # -- loops -----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        """reference: hapi/model.py:2200. Each epoch trains on
        `train_data` (a Dataset, loaded here, or any iterable of batches)
        until `num_iters` batches in all, evaluates on `eval_data` every
        `eval_freq` epochs, and saves `save_dir/<epoch>`."""
        from ..io import DataLoader, Dataset
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        cbks = CallbackList((callbacks or [])
                            + [ProgBarLogger(log_freq, verbose)])
        cbks.set_model(self)
        cbks.set_params({"epochs": epochs, "steps": None,
                         "verbose": verbose,
                         "metrics": ["loss"] + [n for m in self._metrics
                                                for n in _names(m)]})
        cbks.on_train_begin()
        self.stop_training = False
        it_count = 0
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                x, y = self._split_batch(batch)
                logs = {"loss": self.train_batch(x, y)[0]}
                for m in self._metrics:
                    logs.update(_metric_logs(m))
                cbks.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=0, callbacks=callbacks)
            if save_dir:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                break
        cbks.on_train_end()

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 2:
                return batch[0], batch[1]
            return batch[:-1], batch[-1]
        return batch, None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """{"loss": [mean of the batches' losses], <metric name>: value}.
        `callbacks` is accepted and not called, as in the reference."""
        from ..io import DataLoader, Dataset
        loader = (DataLoader(eval_data, batch_size=batch_size,
                             num_workers=num_workers)
                  if isinstance(eval_data, Dataset) else eval_data)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            x, y = self._split_batch(batch)
            losses.append(self.eval_batch(x, y)[0])
        result = {"loss": [float(np.mean(losses))] if losses else [0.0]}
        for m in self._metrics:
            result.update(_metric_logs(m))
        if verbose:
            print("Eval:", result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset
        loader = (DataLoader(test_data, batch_size=batch_size,
                             num_workers=num_workers)
                  if isinstance(test_data, Dataset) else test_data)
        outputs = []
        for batch in loader:
            x, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(x))
        if stack_outputs and outputs and isinstance(outputs[0],
                                                    torch.Tensor):
            return [torch.cat(outputs, 0)]
        return [outputs]

    # -- checkpoints -----------------------------------------------------
    def save(self, path, training=True):
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = _load(path + ".pdparams") if os.path.exists(
            path + ".pdparams") else _load(path)
        self.network.load_state_dict(state, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def _names(metric):
    n = metric.name()
    return n if isinstance(n, list) else [n]


def _metric_logs(metric):
    vals = metric.accumulate()
    return dict(zip(_names(metric),
                    vals if isinstance(vals, list) else [vals]))


def summary(net, input_size=None, dtypes=None, input=None):
    """Each parameter's name, shape and count, and the totals.
    reference: python/paddle/hapi/model_summary.py."""
    rows = []
    total = trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    print(f"{'Layer (param)':<{width}}{'Shape':<20}{'Param #':<12}")
    print("-" * (width + 32))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<20}{n:<12}")
    print("-" * (width + 32))
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total - trainable}")
    return {"total_params": total, "trainable_params": trainable}

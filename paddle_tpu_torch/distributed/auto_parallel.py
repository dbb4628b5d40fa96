"""Static auto-parallel: Strategy / Engine / DistModel / to_static.
reference: paddle_tpu/distributed/auto_parallel.py (`Strategy` :38,
`_build_mesh` :57, `Engine` :70-219, `DistModel` :222, `to_static` :272).

The reference's Engine builds one compiled GSPMD step through
parallel.SpmdTrainer; the port's Engine drives the port's SpmdTrainer,
whose tensors carry the reference's placements on a mesh that may lie on
one card (parallel/spmd.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.device import device_count
from .placement import P

__all__ = ["Strategy", "Engine", "DistModel", "to_static"]


class _Cfg:
    """Attribute bag with defaults (mirrors the reference's config nodes)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        return f"_Cfg({self.__dict__})"


class Strategy:
    """reference: auto_parallel.py:38 — the knobs:

    - sharding: ZeRO over the 'sharding' mesh axis (enable, stage, degree)
    - recompute: one checkpoint around the whole loss
    - mp_degree / sep_degree: tensor / sequence-parallel mesh axis sizes
    - amp: cast floating state to `amp.dtype` (bfloat16)
    """

    def __init__(self):
        self.sharding = _Cfg(enable=False, stage=1, degree=1)
        self.recompute = _Cfg(enable=False)
        self.amp = _Cfg(enable=False, dtype="bfloat16")
        self.mp_degree = 1
        self.sep_degree = 1
        self.dp_degree = None  # None = all remaining devices


def _build_mesh(strategy, n_devices=None, *, device=None):
    """The strategy's mesh over `n_devices` (the CUDA device count if
    None): dp takes what mp, sep and sharding leave, at least 1, so a
    2x2 mesh lies on one card."""
    from ..parallel.spmd import create_mesh
    if n_devices is None:
        n_devices = device_count()
    mp = max(1, int(strategy.mp_degree))
    sep = max(1, int(strategy.sep_degree))
    shd = max(1, int(strategy.sharding.degree)) if strategy.sharding.enable \
        else 1
    rest = n_devices // (mp * sep * shd)
    dp = strategy.dp_degree or max(1, rest)
    return create_mesh(dp=dp, mp=mp, sep=sep, sharding=shd, device=device)


def _device_of(model):
    first = next(iter(model.parameters()), None) if model is not None \
        else None
    return first.device if first is not None else None


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Engine:
    """reference: auto_parallel.py:70.

    engine = Engine(model, loss, optimizer, strategy=strategy)
    engine.fit(dataset, epochs, batch_size)
    engine.evaluate(dataset, batch_size)
    engine.predict(dataset, batch_size)
    """

    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 strategy=None, mesh=None, rules=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics or []
        self._strategy = strategy or Strategy()
        self._mesh = mesh
        self._rules = rules
        self._trainer = None
        self._eval_fn = None
        self._pred_fn = None
        self.history = {"loss": []}

    # -- plumbing ----------------------------------------------------------
    def _process_mesh(self):
        if self._mesh is None:
            self._mesh = _build_mesh(self._strategy,
                                     device=_device_of(self._model))
        return self._mesh

    def _ensure_trainer(self):
        if self._trainer is not None:
            return self._trainer
        from ..parallel.spmd import DP_ONLY_RULES, SpmdTrainer
        st = self._strategy
        stage = st.sharding.stage if st.sharding.enable else 0
        self._trainer = SpmdTrainer(
            self._model, self._optimizer, self._process_mesh(),
            self._rules or DP_ONLY_RULES,
            loss_fn=self._loss, batch_spec=P("dp"),
            remat=st.recompute.enable,
            dtype=st.amp.dtype if st.amp.enable else None,
            sharding_stage=stage)
        return self._trainer

    def _as_loader(self, data, batch_size, shuffle=False, drop_last=False):
        """drop_last only for fit (stable shapes); eval/predict must see
        every sample."""
        from ..io import DataLoader
        if data is None:
            return None
        if hasattr(data, "__iter__") and not hasattr(data, "__getitem__"):
            return data  # already an iterable loader
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last)

    def _get_eval_fn(self):
        """Eval-mode loss (dropout off, BN running stats), no autograd."""
        if self._eval_fn is None:
            from ..parallel.functional import make_loss_fn
            fn = make_loss_fn(self._model, self._loss, training=False)
            self._eval_fn = torch.no_grad()(fn)
        return self._eval_fn

    def _get_pred_fn(self):
        if self._pred_fn is None:
            from ..parallel.functional import functional_call

            @torch.no_grad()
            def fwd(params, x, key):
                out = functional_call(self._model, params, x, rng_key=key,
                                      training=False)
                return out[1] if isinstance(out, (tuple, list)) else out

            self._pred_fn = fwd
        return self._pred_fn

    def _arrays(self, batch):
        from ..parallel.spmd import _to_device
        return _to_device(batch, self._process_mesh().device)

    # -- public API --------------------------------------------------------
    def prepare(self, *args, **kwargs):
        """Build the trainer now (the reference's static warm-up)."""
        self._ensure_trainer()
        return self

    def fit(self, train_data, epochs=1, batch_size=1, steps_per_epoch=None,
            verbose=0, **kw):
        trainer = self._ensure_trainer()
        loader = self._as_loader(train_data, batch_size, shuffle=True,
                                 drop_last=True)
        for epoch in range(epochs):
            for i, batch in enumerate(loader):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                loss = trainer.step(batch)
                self.history["loss"].append(float(loss))
                if verbose and i % max(1, verbose) == 0:
                    print(f"[engine] epoch {epoch} step {i} "
                          f"loss {float(loss):.4f}", flush=True)
        trainer.sync_to_model()
        return self.history

    def evaluate(self, valid_data, batch_size=1, steps=None, verbose=0, **kw):
        trainer = self._ensure_trainer()
        eval_fn = self._get_eval_fn()
        loader = self._as_loader(valid_data, batch_size)
        losses = []
        for i, batch in enumerate(loader):
            if steps is not None and i >= steps:
                break
            losses.append(float(eval_fn(trainer.params, self._arrays(batch),
                                        0)))
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    def predict(self, test_data, batch_size=1, steps=None, **kw):
        """Each batch's outputs as a numpy array (bf16 as float32)."""
        trainer = self._ensure_trainer()
        pred = self._get_pred_fn()
        loader = self._as_loader(test_data, batch_size)
        outs = []
        for i, batch in enumerate(loader):
            if steps is not None and i >= steps:
                break
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            outs.append(_numpy(pred(trainer.params, self._arrays(x), 0)))
        return outs

    def save(self, path, training=True):
        self._ensure_trainer().sync_to_model()
        from ..framework.io_file import save
        save(self._model.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path):
        from ..framework.io_file import load
        self._model.set_state_dict(load(path + ".pdparams"))
        self._trainer = None  # lay out again from the restored weights

    @property
    def main_program(self):
        """The trainer's step function once built (the reference's
        compiled step), else None."""
        t = self._trainer
        return None if t is None else t._compiled


class DistModel:
    """reference: auto_parallel.py:222 (returned by to_static).

    dist_model(*batch) runs ONE step in the current mode ('train' -> loss
    and parameter update, 'eval' -> loss, 'predict' -> outputs).
    """

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, mesh=None, rules=None):
        self._engine = Engine(layer, loss, optimizer, strategy=strategy,
                              mesh=mesh, rules=rules)
        self._loader = loader
        self._mode = "train" if optimizer is not None else (
            "eval" if loss is not None else "predict")

    def train(self):
        self._mode = "train"
        return self

    def eval(self):
        self._mode = "eval"
        return self

    def predict(self):
        self._mode = "predict"
        return self

    def __call__(self, *batch):
        eng = self._engine
        trainer = eng._ensure_trainer()
        if len(batch) == 1:
            batch = batch[0]
        if self._mode == "train":
            return trainer.step(batch)
        arrays = eng._arrays(batch)
        if self._mode == "eval":
            return eng._get_eval_fn()(trainer.params, arrays, 0)
        x = arrays[0] if isinstance(arrays, (tuple, list)) else arrays
        return eng._get_pred_fn()(trainer.params, x, 0)

    def state_dict(self, mode="all"):
        self._engine._ensure_trainer().sync_to_model()
        return self._engine._model.state_dict()

    @property
    def engine(self):
        return self._engine


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              mesh=None, rules=None):
    """reference: auto_parallel.py:272 — the distributed form of a
    layer."""
    return DistModel(layer, loader, loss, optimizer, strategy=strategy,
                     mesh=mesh, rules=rules)

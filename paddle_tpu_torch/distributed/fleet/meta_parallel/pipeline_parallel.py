"""Pipeline-parallel runtime. reference: paddle_tpu/distributed/fleet/
meta_parallel/pipeline_parallel.py, after fleet/meta_parallel/
pipeline_parallel.py (PipelineParallel:255, the 1F1B schedule :575).

The micro-batch loop with gradient accumulation: the optimizer sees the
gradients a 1F1B schedule gives (the mean over micro-batches), from one
process that runs every stage. The tick-by-tick schedules (FThenB, 1F1B,
VPP, ZB) are parallel/pipeline.py's.
"""

from __future__ import annotations

import torch

from ....nn.layer.layers import Layer

__all__ = ["PipelineParallel"]


class PipelineParallel(Layer):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self._hcg = hcg
        cfg = getattr(strategy, "pipeline_configs", {}) or {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1) or 1)
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1) or 1)
        self.total_loss = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _split_micro(self, data):
        if isinstance(data, (tuple, list)):
            xs, ys = data
        else:
            xs, ys = data, None
        bs = xs.shape[0]
        mbs = max(bs // self.accumulate_steps, 1)
        return [(xs[i:i + mbs], ys[i:i + mbs] if ys is not None else None)
                for i in range(0, bs, mbs)]

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference: pipeline_parallel.py:train_batch — the mean loss of
        the micro-batches, after one optimizer step on their summed
        loss / n gradients."""
        self._layers.train()
        micro = self._split_micro(data)
        total = None
        loss_fn = getattr(self._layers, "_loss_fn", None)
        for x_i, y_i in micro:
            out = self._layers(x_i)
            loss = loss_fn(out, y_i) if loss_fn is not None else out
            scaled = loss / len(micro)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total = loss.detach() if total is None else total + loss.detach()
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total / len(micro)

    def eval_batch(self, data, compute_loss=True):
        self._layers.eval()
        micro = self._split_micro(data)
        loss_fn = getattr(self._layers, "_loss_fn", None)
        total = None
        with torch.no_grad():
            for x_i, y_i in micro:
                out = self._layers(x_i)
                loss = loss_fn(out, y_i) if (loss_fn and compute_loss) \
                    else out
                total = loss if total is None else total + loss
        return total / len(micro)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)

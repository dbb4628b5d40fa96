"""A pipelined Llama: the model's decoder stack under a pipeline schedule
over the pp axis. reference: paddle_tpu/parallel/llama_pipeline.py
(`LlamaPipeRunner` :29).

The per-layer parameters are stacked into (pp, layers_per_stage, ...)
tensors (VPP: (pp, num_chunks, layers_per_chunk, ...)) marked Shard(0) on
the pp axis; the stage function re-runs one LlamaDecoderLayer template
through `functional_call`, so its attention goes through the router to
K1, K3 and K4 as the model's own does. The embedding, the final norm and
the head stay replicated.
"""

from __future__ import annotations

import torch

from ..distributed.placement import P, spec_to_placements
from .functional import (functional_call, rmsnorm_lm_loss,
                         split_stacked_layer_params)
from .pipeline import (InterleavedPipelinedLM, OneFOneBPipeline,
                       PipelinedLM, ZeroBubblePipeline)

__all__ = ["LlamaPipeRunner"]

_SCHEDULES = {"fthenb": "FThenB", "1f1b": "1F1B", "vpp": "VPP",
              "interleaved": "VPP", "zb": "ZB", "zbh1": "ZB",
              "zerobubble": "ZB"}


def _mark(t, mesh, spec):
    t.process_mesh = mesh
    t.placements = spec_to_placements(spec, mesh, t.ndim)
    return t


class LlamaPipeRunner:
    """Run a LlamaForCausalLM under a pipeline schedule.

    schedule: "FThenB" (fill-drain, autograd backward), "1F1B" (the
    hand-scheduled backward with the O(P) activation bound), "VPP"
    (interleaved, `num_chunks` chunks a stage) or "ZB" (1F1B with the
    weight gradients deferred); None reads FLAGS_pipeline_schedule. Tied
    embeddings (config.tie_word_embeddings) need 1F1B or ZB, which route
    the head's embedding cotangent into the embedding's gradient.
    `step(tokens, labels)` runs one training step: `grads` under the
    schedule, then `update`, `optimizer`'s functional update of every
    tensor of each group (embed, stage, head)."""

    def __init__(self, model, mesh, num_microbatches, axis_name="pp",
                 batch_axis=None, optimizer=None, schedule=None,
                 num_chunks=2):
        self.model = model
        self.mesh = mesh
        self.axis = axis_name
        if schedule is None:
            from ..framework import flags as _flags
            schedule = _flags.flag_value("pipeline_schedule")
        schedule = _SCHEDULES.get(schedule.lower().replace("-", ""),
                                  schedule)
        if schedule not in ("FThenB", "1F1B", "VPP", "ZB"):
            raise ValueError(f"unknown pipeline schedule: {schedule!r} "
                             "(expected 'FThenB', '1F1B', 'VPP' or 'ZB')")
        self.schedule = schedule
        cfg = model.config
        pp = mesh.get_dim_size(axis_name)
        n_layers = cfg.num_hidden_layers
        self.optimizer = optimizer
        if schedule == "VPP":
            assert n_layers % (pp * num_chunks) == 0, (
                f"layers {n_layers} must divide pp*num_chunks "
                f"{pp}*{num_chunks}")
            self.layers_per_stage = n_layers // (pp * num_chunks)
            self.num_chunks = num_chunks
        else:
            assert n_layers % pp == 0, f"layers {n_layers} must divide pp {pp}"
            self.layers_per_stage = n_layers // pp

        state = {k: v.detach() for k, v in model.state_dict().items()}
        stacked, other = split_stacked_layer_params(state)
        lps = self.layers_per_stage
        self.stage_params = {}
        for name, arr in stacked.items():
            if schedule == "VPP":
                # (L, ...) -> (pp, V, Lv, ...): element [s, c] holds
                # virtual stage c * pp + s, layers (c * pp + s) * Lv + j
                arr = arr.reshape((self.num_chunks, pp, lps) + arr.shape[1:])
                arr = arr.transpose(0, 1).contiguous()
            else:
                arr = arr.reshape((pp, lps) + arr.shape[1:])
            self.stage_params[name] = _mark(arr, mesh, P(axis_name))
        self.embed_params = {"weight": _mark(
            other["llama.embed_tokens.weight"].clone(), mesh, P())}
        self.head_params = {"norm": _mark(
            other["llama.norm.weight"].clone(), mesh, P())}
        if "lm_head.weight" in other:
            self.head_params["lm_head"] = _mark(
                other["lm_head.weight"].clone(), mesh, P())

        template = model.llama.layers[0]
        eps = cfg.rms_norm_eps

        def embed_fn(ep, tokens):
            return torch.nn.functional.embedding(tokens, ep["weight"])

        def stage_fn(sp, h):
            # sp's leaves: (lps, ...); the stage's layers in order
            for i in range(lps):
                h = functional_call(template, {k: v[i] for k, v in
                                               sp.items()}, h)
            return h

        tied = "lm_head" not in self.head_params
        if tied and schedule not in ("1F1B", "ZB"):
            raise NotImplementedError(
                "tied embeddings need the 1F1B or ZB schedule "
                "(LlamaPipeRunner(..., schedule='1F1B')), which routes the "
                "head's embedding cotangent back into the embedding grad")

        def head_loss_fn(hp, h, labels):
            return rmsnorm_lm_loss(hp["norm"], hp["lm_head"], h, labels, eps)

        def head_loss_fn_tied(hp, ep, h, labels):
            return rmsnorm_lm_loss(hp["norm"], ep["weight"].T, h, labels, eps)

        self._loss_fn = self._grads_fn = None
        if schedule in ("1F1B", "ZB"):
            pipe_cls = (ZeroBubblePipeline if schedule == "ZB"
                        else OneFOneBPipeline)
            self._pipe = pipe_cls(
                mesh, embed_fn, stage_fn,
                head_loss_fn_tied if tied else head_loss_fn,
                num_microbatches, axis_name, batch_axis=batch_axis,
                tied_embed=tied)
            self._grads_fn = self._pipe.loss_and_grad_fn()
            if not tied:
                # the forward-only loss: the same micro-batching without
                # the scheduled backward
                self._loss_fn = PipelinedLM(
                    mesh, embed_fn, stage_fn, head_loss_fn,
                    num_microbatches, axis_name,
                    batch_axis=batch_axis).loss_fn()
        elif schedule == "VPP":
            self._plm = InterleavedPipelinedLM(
                mesh, embed_fn, stage_fn, head_loss_fn, num_microbatches,
                self.num_chunks, axis_name, batch_axis=batch_axis)
            self._loss_fn = self._plm.loss_fn()
        else:
            self._plm = PipelinedLM(mesh, embed_fn, stage_fn, head_loss_fn,
                                    num_microbatches, axis_name,
                                    batch_axis=batch_axis)
            self._loss_fn = self._plm.loss_fn()
        self.step_count = 0
        if optimizer is not None:
            self.opt_states = {
                group: {k: optimizer.init_state(v) for k, v in
                        params.items()}
                for group, params in self._groups()}

    def _groups(self):
        return (("embed", self.embed_params), ("stage", self.stage_params),
                ("head", self.head_params))

    def loss(self, tokens, labels):
        """The schedule's loss of one batch, without an update."""
        with torch.no_grad():
            if self._loss_fn is not None:
                return self._loss_fn(self.embed_params, self.stage_params,
                                     self.head_params, tokens, labels)
            return self._grads_fn(self.embed_params, self.stage_params,
                                  self.head_params, tokens, labels)[0]

    def grads(self, tokens, labels):
        """(loss, (demb, dstage, dhead)) of one batch under the schedule."""
        if self._grads_fn is not None:
            loss, demb, dstage, dhead = self._grads_fn(
                self.embed_params, self.stage_params, self.head_params,
                tokens, labels)
            return loss, (demb, dstage, dhead)
        trees = [{k: v.detach().requires_grad_() for k, v in params.items()}
                 for _, params in self._groups()]
        with torch.enable_grad():
            loss = self._loss_fn(*trees, tokens, labels)
            flat = [v for tree in trees for v in tree.values()]
            gs = iter(torch.autograd.grad(loss, flat))
        return loss.detach(), tuple({k: next(gs) for k in tree}
                                    for tree in trees)

    def update(self, grads):
        """The optimizer's update of every tensor from `grads`, the
        (demb, dstage, dhead) of `grads()`; counts one step."""
        self.step_count += 1
        lr = float(self.optimizer.get_lr())
        with torch.no_grad():
            for (group, params), g in zip(self._groups(), grads):
                for k, p in params.items():
                    self.optimizer.update(p, g[k].to(p.dtype),
                                          self.opt_states[group][k], lr,
                                          self.step_count)

    def step(self, tokens, labels):
        """One training step; returns the loss (a float32 device scalar)."""
        loss, grads = self.grads(tokens, labels)
        self.update(grads)
        return loss

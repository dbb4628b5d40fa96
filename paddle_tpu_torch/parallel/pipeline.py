"""Pipeline parallelism over the 'pp' mesh axis. reference:
paddle_tpu/parallel/pipeline.py (`pipeline_forward` :53,
`pipeline_forward_interleaved` :104, `pipeline_1f1b_grads` :173,
`OneFOneBPipeline` :448, `ZeroBubblePipeline` :520, `PipelinedLM` :537,
`InterleavedPipelinedLM` :614).

The reference's schedule is a lax.scan over ticks inside one shard_map:
each device runs its stage's block of the stacked parameters and passes
activations (and, under 1F1B, cotangents) to its neighbour with ppermute.
The port keeps the global view of distributed/placement.py: the stacked
parameters hold every stage's block (leading dim = the pp size, stage s's
block being its `chunk_map` block), and the schedule is a host loop over
the same ticks that runs, at each tick, every stage's work of that tick in
stage order. What a stage sends with ppermute is what the next stage reads
at the next tick. On one card the stages run one after another, so the
loop keeps the schedule's order and its memory shape (1F1B's live-input
buffer of min(m, 2p - 1) entries a stage), not its overlap.

Pytrees of parameters are dicts, lists or tuples of tensors, or a tensor.
The functions return the last stage's results where the reference returns
them under shard_map's out_specs: `pipeline_forward` the (M, mb, ...)
outputs valid on the last stage, `pipeline_1f1b_grads` the psum'd loss and
gradients with the stage gradients stacked (pp, ...).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

__all__ = ["pipeline_forward", "pipeline_1f1b_grads", "PipelinedLM",
           "OneFOneBPipeline", "ZeroBubblePipeline",
           "InterleavedPipelinedLM"]


def _block(tree, *index):
    """Stage `index`'s block of every stacked leaf."""
    return pytree.tree_map(lambda a: a[index], tree)


def _remat(stage_fn, remat):
    if not remat:
        return stage_fn

    def fn(params, h):
        if not torch.is_grad_enabled():
            return stage_fn(params, h)
        return checkpoint(stage_fn, params, h, use_reentrant=False)
    return fn


def pipeline_forward(stage_fn: Callable, stacked_stage_params, inputs_mb,
                     axis_name="pp", *, p_size, remat=True, vary_axes=None):
    """The fill-drain (GPipe) forward: at tick t stage s runs micro-batch
    t - s of inputs_mb (M, mb, ...), stage 0 reading inputs_mb and stage s
    what stage s - 1 produced the tick before. stacked_stage_params' leaves
    have leading dim p_size. Returns the last stage's (M, mb, ...) outputs,
    differentiable by autograd; remat recomputes each stage call in the
    backward (torch.utils.checkpoint)."""
    m = inputs_mb.shape[0]
    fn = _remat(stage_fn, remat)
    params = [_block(stacked_stage_params, s) for s in range(p_size)]
    recv = [None] * p_size
    outs = [None] * m
    for t in range(m + p_size - 1):
        sent = [None] * p_size
        for s in range(p_size):
            i = t - s
            if not 0 <= i < m:
                continue
            h = fn(params[s], inputs_mb[i] if s == 0 else recv[s])
            if s == p_size - 1:
                outs[i] = h
            else:
                sent[s + 1] = h
        recv = sent
    return torch.stack(outs)


def pipeline_forward_interleaved(stage_fn: Callable, stacked_chunk_params,
                                 inputs_mb, axis_name="pp", *, p_size,
                                 num_chunks, remat=True, vary_axes=None):
    """The interleaved (VPP) forward. Leaves of stacked_chunk_params have
    leading dims (p_size, num_chunks): element [s, c] is virtual stage
    c * P + s. The reference's schedule: at tick t stage s has local time
    u = t - s and runs chunk c = (u // P) % V of micro-batch
    i = (u // (V * P)) * P + u % P; activations flow s -> s + 1 within a
    chunk and wrap P - 1 -> 0 between chunks. M must divide by P. Returns
    the last virtual stage's (M, mb, ...) outputs."""
    p, v = p_size, num_chunks
    m = inputs_mb.shape[0]
    if m % p != 0:
        raise ValueError(f"interleaved schedule needs microbatches {m} % "
                         f"pp {p} == 0")
    fn = _remat(stage_fn, remat)
    params = [[_block(stacked_chunk_params, s, c) for c in range(v)]
              for s in range(p)]
    steps = (m // p) * v * p + (p - 1) + (v - 1) * p
    recv = [None] * p
    outs = [None] * m
    for t in range(steps):
        sent = [None] * p
        for s in range(p):
            u = t - s
            if u < 0:
                continue
            c = (u // p) % v
            i = (u // (v * p)) * p + u % p
            if i >= m:
                continue
            h = fn(params[s][c],
                   inputs_mb[i] if s == 0 and c == 0 else recv[s])
            if s == p - 1 and c == v - 1:
                outs[i] = h
            else:
                sent[(s + 1) % p] = h
        recv = sent
    return torch.stack(outs)


def _accumulating(tree, grads):
    """Leaves that require grad, sharing `tree`'s storage, each with its
    `.grad` set to the matching leaf of `grads`: autograd's backward adds
    into it in place."""
    def leaf(a, g):
        t = a.detach().requires_grad_()
        t.grad = g
        return t
    return pytree.tree_map(leaf, tree, grads)


def pipeline_1f1b_grads(embed_fn, stage_fn, head_loss_fn, embed_params,
                        stacked_stage_params, head_params, tokens_mb,
                        labels_mb, axis_name="pp", *, p_size,
                        num_microbatches, vary_axes=None, tied_embed=False,
                        wgrad_deferred=False):
    """The 1F1B schedule, forward and backward by hand: at tick t stage s
    runs the forward of micro-batch i = t - s and the backward of
    micro-batch j = t - 2(P - 1) + s, over the fill (forwards only),
    steady and drain (backwards only) phases. A stage keeps its inputs in a
    buffer of k = min(M, 2P - 1) entries (the O(P) bound; M under
    `wgrad_deferred`), and its backward recomputes the stage from the saved
    input; the weight gradients accumulate in place, in micro-batch order
    and in the parameters' dtype, into the stacked gradient returned. The
    last stage's forward output is never sent, so the last stage runs its
    forward only inside its backward. Stage 0's input cotangents are
    recorded and the embedding's backward runs after the ticks,
    micro-batch by micro-batch.

    head_loss_fn(head_params, h, labels), or with `tied_embed`
    head_loss_fn(head_params, embed_params, h, labels) whose embedding
    cotangent joins the embedding's gradient. With `wgrad_deferred` (the
    zero-bubble schedule) the ticks compute only input cotangents and
    record each micro-batch's output cotangent; each stage's weight
    gradient is then one backward over all M micro-batches concatenated on
    the leading (batch) dim, which stage_fn must map row by row.

    Returns (loss, demb, dstage, dhead): the mean of the micro-batches'
    losses (float32) and the gradients of the embedding, the stacked stage
    parameters (leading dim P) and the head."""
    p, m = p_size, num_microbatches
    k = m if wgrad_deferred else min(m, 2 * p - 1)
    inv_m = 1.0 / m
    demb, dhead, dstage = (pytree.tree_map(torch.zeros_like, t) for t in (
        embed_params, head_params, stacked_stage_params))
    ep, hp = _accumulating(embed_params, demb), \
        _accumulating(head_params, dhead)
    sp = [_accumulating(_block(stacked_stage_params, s), _block(dstage, s))
          for s in range(p)]
    head_leaves = pytree.tree_leaves(hp) + (
        pytree.tree_leaves(ep) if tied_embed else [])
    buf = [[None] * k for _ in range(p)]
    dhout = [[None] * m for _ in range(p)]
    dh0 = [None] * m
    loss = torch.zeros((), dtype=torch.float32, device=tokens_mb.device)
    recv_f, recv_b = [None] * p, [None] * p

    def head(h, lab):
        if tied_embed:
            return head_loss_fn(hp, ep, h, lab)
        return head_loss_fn(hp, h, lab)

    for t in range(m + 2 * (p - 1)):
        send_f, send_b = [None] * p, [None] * p
        for s in range(p):
            i = t - s
            if t < m + p - 1 and 0 <= i < m:
                with torch.no_grad():
                    h_in = (embed_fn(ep, tokens_mb[i]) if s == 0
                            else recv_f[s])
                    buf[s][i % k] = h_in
                    if s < p - 1:
                        send_f[s + 1] = stage_fn(sp[s], h_in)
            j = t - 2 * (p - 1) + s
            if not 0 <= j < m:
                continue
            last = s == p - 1
            with torch.enable_grad():
                h = buf[s][j % k].detach().requires_grad_()
                h_out = stage_fn(sp[s], h)
                if last:
                    loss_j = head(h_out, labels_mb[j])
                    outs, seeds = [loss_j * inv_m], None
                    loss += loss_j.detach().float() * inv_m
                else:
                    outs, seeds = [h_out], [recv_b[s]]
                extra = head_leaves if last else []
                if not wgrad_deferred:
                    torch.autograd.backward(
                        outs, seeds,
                        inputs=pytree.tree_leaves(sp[s]) + extra + [h])
                    dh_in = h.grad
                else:
                    grads = torch.autograd.grad(
                        outs, extra + ([h_out] if last else []) + [h], seeds,
                        allow_unused=True)
                    for leaf, g in zip(extra, grads):
                        if g is not None:
                            leaf.grad.add_(g.to(leaf.grad.dtype))
                    dhout[s][j] = grads[-2] if last else recv_b[s]
                    dh_in = grads[-1]
            if s == 0:
                dh0[j] = dh_in
            else:
                send_b[s - 1] = dh_in
        recv_f, recv_b = send_f, send_b

    # the embedding's backward from stage 0's recorded input cotangents
    for j in range(m):
        with torch.enable_grad():
            torch.autograd.backward([embed_fn(ep, tokens_mb[j])], [dh0[j]],
                                    inputs=pytree.tree_leaves(ep))
    if wgrad_deferred:
        # one backward a stage over all M micro-batches (buf is in
        # micro-batch order: k == M)
        for s in range(p):
            with torch.enable_grad():
                torch.autograd.backward(
                    [stage_fn(sp[s], torch.cat(buf[s]))],
                    [torch.cat(dhout[s])], inputs=pytree.tree_leaves(sp[s]))
    return loss, demb, dstage, dhead


def _batch_chunks(mesh, batch_axis, tokens, labels):
    """The batch's blocks over the dp axis, as shard_map hands them out."""
    n = mesh.get_dim_size(batch_axis) if batch_axis is not None else 1
    return list(zip(tokens.chunk(n), labels.chunk(n)))


def _mean_trees(trees):
    n = len(trees)
    if n == 1:
        return trees[0]
    return pytree.tree_map(lambda *xs: sum(xs) / n, *trees)


class OneFOneBPipeline:
    """1F1B-scheduled pipelined LM: `loss_and_grad_fn()` returns
    f(embed_params, stage_params, head_params, tokens, labels) ->
    (loss, demb, dstage, dhead), the backward being part of the schedule.
    Stage params are stacked with leading dim = the pp size. With
    `batch_axis`, the batch's blocks over that axis each run the schedule
    and the losses and gradients are averaged (the reference's pmean).
    With `tied_embed`, head_loss_fn(head_params, embed_params, h, labels)
    may read the embedding weight and its gradient flows into the
    embedding's."""

    wgrad_deferred = False  # ZeroBubblePipeline flips this

    def __init__(self, mesh, embed_fn, stage_fn, head_loss_fn,
                 num_microbatches, axis_name="pp", batch_axis=None,
                 tied_embed=False):
        self.mesh = mesh
        self.embed_fn = embed_fn
        self.stage_fn = stage_fn
        self.head_loss_fn = head_loss_fn
        self.m = num_microbatches
        self.axis = axis_name
        self.batch_axis = batch_axis
        self.tied_embed = tied_embed

    def loss_and_grad_fn(self):
        p_size = self.mesh.get_dim_size(self.axis)
        m = self.m

        def grads_fn(embed_params, stage_params, head_params, tokens,
                     labels):
            outs = []
            for tok, lab in _batch_chunks(self.mesh, self.batch_axis,
                                          tokens, labels):
                b = tok.shape[0]
                outs.append(pipeline_1f1b_grads(
                    self.embed_fn, self.stage_fn, self.head_loss_fn,
                    embed_params, stage_params, head_params,
                    tok.reshape((m, b // m) + tok.shape[1:]),
                    lab.reshape((m, b // m) + lab.shape[1:]), self.axis,
                    p_size=p_size, num_microbatches=m,
                    tied_embed=self.tied_embed,
                    wgrad_deferred=self.wgrad_deferred))
            return _mean_trees(outs)

        return grads_fn


class ZeroBubblePipeline(OneFOneBPipeline):
    """The deferred-weight-gradient schedule (the reference's ZB): ticks
    compute only input cotangents, and each stage's weight gradient is one
    backward over all micro-batches after the ticks."""

    wgrad_deferred = True


class PipelinedLM:
    """End-to-end pipelined LM: `loss_fn()` returns
    f(embed_params, stage_params, head_params, tokens, labels) -> the mean
    of the micro-batches' losses, differentiable by autograd (the
    fill-drain schedule, FThenB).

    embed_fn(embed_params, tokens) -> h, stage_fn(stage_params, h) -> h,
    head_loss_fn(head_params, h, labels) -> loss. Stage params are stacked
    with leading dim = the pp size."""

    def __init__(self, mesh, embed_fn, stage_fn, head_loss_fn,
                 num_microbatches, axis_name="pp", batch_axis=None,
                 remat=True):
        self.mesh = mesh
        self.embed_fn = embed_fn
        self.stage_fn = stage_fn
        self.head_loss_fn = head_loss_fn
        self.m = num_microbatches
        self.axis = axis_name
        self.batch_axis = batch_axis
        self.remat = remat

    def _pipeline_forward(self, stage_p, h_mb, p_size, vary):
        """The schedule hook: subclasses swap the forward program."""
        return pipeline_forward(self.stage_fn, stage_p, h_mb, self.axis,
                                p_size=p_size, remat=self.remat)

    def loss_fn(self):
        p_size = self.mesh.get_dim_size(self.axis)
        m = self.m

        def spmd_loss(embed_params, stage_params, head_params, tokens,
                      labels):
            total = []
            for tok, lab in _batch_chunks(self.mesh, self.batch_axis,
                                          tokens, labels):
                b = tok.shape[0]
                tok_mb = tok.reshape((m, b // m) + tok.shape[1:])
                lab_mb = lab.reshape((m, b // m) + lab.shape[1:])
                h_mb = torch.stack([self.embed_fn(embed_params, t)
                                    for t in tok_mb])
                out = self._pipeline_forward(stage_params, h_mb, p_size,
                                             None)
                losses = torch.stack([
                    self.head_loss_fn(head_params, h, lab_i)
                    for h, lab_i in zip(out, lab_mb)])
                total.append(losses.float().mean())
            return torch.stack(total).mean()

        return spmd_loss


class InterleavedPipelinedLM(PipelinedLM):
    """The interleaved (VPP) pipelined LM: stage params stacked (pp,
    num_chunks, ...), element [s, c] holding virtual stage c * pp + s;
    everything else is PipelinedLM's."""

    def __init__(self, mesh, embed_fn, stage_fn, head_loss_fn,
                 num_microbatches, num_chunks, axis_name="pp",
                 batch_axis=None, remat=True):
        super().__init__(mesh, embed_fn, stage_fn, head_loss_fn,
                         num_microbatches, axis_name, batch_axis, remat)
        self.v = num_chunks

    def _pipeline_forward(self, stage_p, h_mb, p_size, vary):
        return pipeline_forward_interleaved(
            self.stage_fn, stage_p, h_mb, self.axis, p_size=p_size,
            num_chunks=self.v, remat=self.remat)

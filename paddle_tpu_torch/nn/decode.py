"""Beam search. reference: paddle_tpu/nn/decode.py (`BeamSearchDecoder`,
`dynamic_decode`).

Each step is fixed-shape tensor math: log-softmax of the cell's logits,
top-k over beam * vocab per sentence, states gathered by parent beam. The
loop runs on the host and stops once every beam has finished, one `.item()`
a step, as the reference's does. The beams are back-traced with
`F.gather_tree`.

As the reference: `initialize` puts -1e30 on every beam but the first, so
the first step does not pick one root twice; a finished beam extends only
with `end_token`, at zero cost; states are gathered over any nesting of
tuples, lists and dicts; the output is `(B, T, beam)` `predicted_ids`
after `gather_tree`, the parents in the same layout, the final scores
(B, beam) and the lengths (B, beam), each beam's count of steps taken
before it finished.
"""

from __future__ import annotations

from collections import namedtuple

import torch

from .functional.extras import gather_tree

__all__ = ["BeamSearchDecoder", "dynamic_decode"]

BeamSearchOutput = namedtuple("BeamSearchOutput",
                              ["predicted_ids", "parent_ids", "scores"])


def _map(f, tree):
    """f over every tensor of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map(f, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def _first(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values:
        t = _first(v)
        if t is not None:
            return t
    return None


class BeamSearchDecoder:
    """cell(step_input, states) -> (cell_output, next_states);
    `embedding_fn` maps token ids to step inputs and `output_fn` cell
    outputs to vocabulary logits (None where the cell emits logits)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(B, ...) -> (B * beam, ...), each row repeated beam times."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def initialize(self, initial_cell_states):
        beam = self.beam_size
        states = _map(lambda a: torch.repeat_interleave(a, beam, dim=0),
                      initial_cell_states)
        leaf = _first(states)
        bsz = leaf.shape[0] // beam
        ids = torch.full((bsz * beam,), self.start_token, dtype=torch.int64,
                         device=leaf.device)
        log_probs = torch.full((bsz, beam), -1e30, dtype=torch.float32,
                               device=leaf.device)
        log_probs[:, 0] = 0.0
        finished = torch.zeros(bsz, beam, dtype=torch.bool,
                               device=leaf.device)
        return ids, states, log_probs, finished

    def step(self, ids, states, log_probs, finished):
        total, next_states = self.candidates(ids, states, log_probs,
                                             finished)
        top_val, top_idx = torch.topk(total, self.beam_size)
        return self.select(top_val, top_idx, next_states, finished,
                           total.shape[-1] // self.beam_size)

    def candidates(self, ids, states, log_probs, finished):
        """Every extension's total score, (B, beam * V), and the cell's
        next states (not yet gathered by parent)."""
        beam = self.beam_size
        bsz = log_probs.shape[0]
        step_in = ids if self.embedding_fn is None else self.embedding_fn(ids)
        out, next_states = self.cell(step_in, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        v = out.shape[-1]
        step_lp = torch.log_softmax(out.float(), -1).reshape(bsz, beam, v)
        fin_row = torch.full((v,), -1e30, device=out.device)
        fin_row[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], fin_row, step_lp)
        total = log_probs[..., None] + step_lp               # (B, beam, V)
        return total.reshape(bsz, beam * v), next_states

    def select(self, top_val, top_idx, next_states, finished, vocab):
        """The step's outputs for the chosen extensions `top_idx` (B, beam)
        into beam * vocab, whose totals are `top_val`."""
        beam = self.beam_size
        bsz = top_idx.shape[0]
        parent = top_idx // vocab
        token = top_idx % vocab
        flat_parent = (torch.arange(bsz, device=top_idx.device)[:, None]
                       * beam + parent).reshape(-1)
        next_states = _map(lambda a: a[flat_parent], next_states)
        new_finished = (finished.gather(1, parent)
                        | (token == self.end_token))
        return (token.reshape(-1), next_states, top_val, new_finished,
                token, parent)

def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=True, **kwargs):
    """Decoder steps until every beam finishes or `max_step_num`:
    (BeamSearchOutput, final states, lengths), or without the lengths
    when `return_length` is False."""
    ids, states, log_probs, finished = decoder.initialize(inits)
    tokens, parents = [], []
    lengths = torch.zeros_like(log_probs, dtype=torch.int64)
    for _ in range(int(max_step_num)):
        (ids, states, log_probs, finished, token,
         parent) = decoder.step(ids, states, log_probs, finished)
        tokens.append(token)
        parents.append(parent)
        lengths = lengths + (~finished).long()
        if bool(finished.all()):
            break
    ids_t = torch.stack(tokens)                        # (T, B, beam)
    parents_t = torch.stack(parents)
    full = gather_tree(ids_t, parents_t)
    if not output_time_major:
        full = full.movedim(0, 1)                      # (B, T, beam)
        parents_t = parents_t.movedim(0, 1)
    out = BeamSearchOutput(predicted_ids=full, parent_ids=parents_t,
                           scores=log_probs)
    return (out, states, lengths) if return_length else (out, states)

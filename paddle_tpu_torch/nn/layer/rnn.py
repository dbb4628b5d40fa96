"""Recurrent layers. reference: paddle_tpu/nn/layer/rnn.py (all of it).

Parameter names, shapes and gate orders are the reference's: `weight_ih`
(gates * hidden, input), `weight_hh` (gates * hidden, hidden), `bias_ih`,
`bias_hh`, suffixed `_l{layer}` and `_reverse` in the multi-layer
classes; GRU gates r, z, c and LSTM gates i, f, g, o (:49-70). Every
parameter starts Uniform(-1/sqrt(hidden), 1/sqrt(hidden)); the reference
reads none of the `*_attr` arguments, and neither does the port.

The recurrence is plain torch: `SimpleRNN`/`GRU`/`LSTM` project the inputs
of all steps in one product per layer and direction, then loop over time.
A product of tensors of two float dtypes runs in the wider one, as jnp
promotes bf16 @ f32 where `torch.matmul` raises, so a cell called with the
float32 default states on bf16 weights gives what the reference gives.

As in the reference: `SimpleRNN`/`GRU`/`LSTM` start from zeros whatever
`initial_states` is, and ignore `sequence_length` and `dropout`
(:221-222); `RNN`/`BiRNN` ignore `sequence_length` (:144, :170); `LSTM`
ignores `proj_size` (:273); `get_initial_states` is float32 (:25-33).
"""

from __future__ import annotations

import math

import torch

from ...framework.device import resolve_device
from ..initializer import Uniform
from .layers import Layer, _param

__all__ = ["SimpleRNN", "LSTM", "GRU", "SimpleRNNCell", "LSTMCell",
           "GRUCell", "RNN", "BiRNN", "RNNCellBase"]


def _mm(a, w):
    """a @ w.T in the wider of the two dtypes."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt).T


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """float32 states of `init_value`, (batch, hidden), batch read from
        `batch_ref`'s axis `batch_dim_idx`; an (h, c) pair for an LSTM."""
        z = torch.full((batch_ref.shape[batch_dim_idx], self.hidden_size),
                       init_value, dtype=torch.float32,
                       device=batch_ref.device)
        return (z, z.clone()) if getattr(self, "_is_lstm", False) else z


def _cell_params(layer, input_size, hidden_size, gates, suffix, dtype,
                 device):
    std = 1.0 / math.sqrt(hidden_size)
    init = Uniform(-std, std)
    shapes = {"weight_ih": (gates * hidden_size, input_size),
              "weight_hh": (gates * hidden_size, hidden_size),
              "bias_ih": (gates * hidden_size,),
              "bias_hh": (gates * hidden_size,)}
    return tuple(layer.add_parameter(name + suffix,
                                     _param(None, init, shape, dtype, device))
                 for name, shape in shapes.items())


def _gates(mode, xi, h, c, wh, bh, activation="tanh"):
    """One step from xi = x_t @ wi.T + bi: (h', c'), c' None but for an
    LSTM. The sums run in the reference's order."""
    hs = h.shape[-1]
    if mode == "gru":
        gh = _mm(h, wh) + bh
        r = torch.sigmoid(xi[..., :hs] + gh[..., :hs])
        z = torch.sigmoid(xi[..., hs:2 * hs] + gh[..., hs:2 * hs])
        n = torch.tanh(xi[..., 2 * hs:] + r * gh[..., 2 * hs:])
        return (1 - z) * n + z * h, None
    g = xi + _mm(h, wh) + bh
    if mode == "rnn":
        return (torch.tanh(g) if activation == "tanh" else torch.relu(g)), \
            None
    i = torch.sigmoid(g[..., :hs])
    f = torch.sigmoid(g[..., hs:2 * hs])
    gg = torch.tanh(g[..., 2 * hs:3 * hs])
    o = torch.sigmoid(g[..., 3 * hs:])
    c_new = f * c + i * gg
    return o * torch.tanh(c_new), c_new


class _Cell(RNNCellBase):
    mode, gates = "rnn", 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, dtype="float32",
                 device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, self.gates, "", dtype,
                     device)

    def _step(self, inputs, h, c=None):
        xi = _mm(inputs, self.weight_ih) + self.bias_ih
        return _gates(self.mode, xi, h, c, self.weight_hh, self.bias_hh,
                      self.activation)


class SimpleRNNCell(_Cell):
    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, _ = self._step(inputs, states)
        return h, h


class GRUCell(_Cell):
    mode, gates = "gru", 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, dtype="float32", device=None):
        super().__init__(input_size, hidden_size, "tanh", dtype=dtype,
                         device=device)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, _ = self._step(inputs, states)
        return h, h


class LSTMCell(_Cell):
    mode, gates = "lstm", 4
    _is_lstm = True

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, dtype="float32", device=None):
        super().__init__(input_size, hidden_size, "tanh", dtype=dtype,
                         device=device)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = self._step(inputs, *states)
        return h, (h, c)


class RNN(Layer):
    """A cell run over time: (outputs stacked on the time axis, final
    states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        t_axis = 0 if self.time_major else 1
        states = initial_states
        if states is None:
            states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        steps = range(inputs.shape[t_axis])
        outs = []
        for t in (reversed(steps) if self.is_reverse else steps):
            out, states = self.cell(inputs.select(t_axis, t), states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, t_axis), states


class BiRNN(Layer):
    """A forward and a reversed RNN; outputs joined on the last axis."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.fw = RNN(cell_fw, False, time_major)
        self.bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (None, None) if initial_states is None \
            else initial_states
        o1, st1 = self.fw(inputs, s_fw)
        o2, st2 = self.bw(inputs, s_bw)
        return torch.cat([o1, o2], -1), (st1, st2)


class _RNNBase(Layer):
    mode, gates = "rnn", 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 dtype="float32", device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        device = resolve_device(device)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_s = (input_size if layer == 0
                        else hidden_size * self.num_directions)
                _cell_params(self, in_s, hidden_size, self.gates,
                             f"_l{layer}" + ("_reverse" if d else ""),
                             dtype, device)

    def _weights(self, layer, d):
        s = f"_l{layer}" + ("_reverse" if d else "")
        return (getattr(self, "weight_ih" + s), getattr(self, "weight_hh" + s),
                getattr(self, "bias_ih" + s), getattr(self, "bias_hh" + s))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        a = inputs if self.time_major else inputs.transpose(0, 1)  # (T, B, C)
        T, B = a.shape[0], a.shape[1]
        is_lstm = self.mode == "lstm"
        h_finals, c_finals = [], []
        layer_in = a
        for layer in range(self.num_layers):
            outs_dir = []
            for d in range(self.num_directions):
                wi, wh, bi, bh = self._weights(layer, d)
                seq = layer_in if d == 0 else layer_in.flip(0)
                xi = _mm(seq, wi) + bi              # every step at once
                h = torch.zeros(B, self.hidden_size, dtype=a.dtype,
                                device=a.device)
                c = torch.zeros_like(h)
                ys = []
                for t in range(T):
                    h, c2 = _gates(self.mode, xi[t], h, c, wh, bh,
                                   self.activation)
                    c = c2 if is_lstm else c
                    ys.append(h)
                ys = torch.stack(ys)
                outs_dir.append(ys.flip(0) if d else ys)
                h_finals.append(h)
                c_finals.append(c)
            layer_in = torch.cat(outs_dir, -1) if d else outs_dir[0]
        out = layer_in if self.time_major else layer_in.transpose(0, 1)
        if is_lstm:
            return out, (torch.stack(h_finals), torch.stack(c_finals))
        return out, torch.stack(h_finals)


class SimpleRNN(_RNNBase):
    mode, gates = "rnn", 1


class GRU(_RNNBase):
    mode, gates = "gru", 3

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, dtype="float32",
                 device=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, dtype=dtype, device=device)


class LSTM(_RNNBase):
    mode, gates = "lstm", 4

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 proj_size=0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 dtype="float32", device=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, dtype=dtype, device=device)

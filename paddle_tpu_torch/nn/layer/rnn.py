"""Recurrent layers: SimpleRNN, LSTM and GRU, their cells, and ``RNN``, which
runs a cell over time (counterpart of paddle_tpu/nn/layer/rnn.py).

The reference runs the time loop as a ``jax.lax.scan``; here it is a Python
loop over steps of plain tensor ops, which ``jit.TrainStep`` captures into
its CUDA graph like any other step. The input projection ``x W_ih^T`` of a
whole layer is one ``torch.matmul`` before the loop; each step then adds
``h W_hh^T`` and applies the gates. cuDNN's fused RNN is not used.

Weights are stored as the reference stores them, ``weight_ih_l{k}`` ``[gates
* H, in]`` and ``weight_hh_l{k}`` ``[gates * H, H]`` (``_reverse`` for the
backward direction), with gates in the order i, f, g, o (LSTM) and r, z, n
(GRU, whose ``b_hh`` stays inside ``r * (h W_hn^T + b_hn)``), all drawn from
``Uniform(-1/sqrt(H), 1/sqrt(H))`` (``reset_parameters(generator)`` draws
them again from an explicit generator). ``convert`` carries them as they
are: they are not Linear weights and are not transposed.

Where the reference ignores an argument the port follows Paddle (ROADMAP
queue 3):

* ``sequence_length`` ``[B]``: a step past a sequence's length leaves its
  state as it was and outputs zeros, so the final states are those of each
  sequence's last valid step, and the backward direction runs over each
  sequence's own steps in reverse (the padding steps come first in its
  loop and change nothing). The mask is built on the device.
* ``dropout``: applied to each layer's output but the last's in training
  (``upscale_in_train``), through one ``Dropout`` layer per gap, whose
  masks are counter-based like every dropout of the port (a model's
  ``DropoutKeys`` may attach them).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..initializer import Uniform
from .common import Dropout
from .layers import ParamLayer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU"]

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _project(mode, x, w_ih, b_ih, b_hh):
    """``x W_ih^T`` plus the biases that add to it: both for LSTM and the
    simple RNN, ``b_ih`` alone for GRU (its ``b_hh`` is gated by r)."""
    bias = b_ih
    if mode != "GRU" and b_hh is not None:
        bias = b_hh if bias is None else bias + b_hh
    out = torch.matmul(x, w_ih.t())
    return out if bias is None else out + bias


def _recur(mode, xw, state, w_hh, b_hh):
    """One step from the projected input ``xw``: ``(new state, output)``."""
    if mode == "LSTM":
        h, c = state
        gates = xw + torch.matmul(h, w_hh.t())
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h
    if mode == "GRU":
        gh = torch.matmul(state, w_hh.t())
        if b_hh is not None:
            gh = gh + b_hh
        ir, iz, inn = xw.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        h = (1 - z) * n + z * state
        return h, h
    pre = xw + torch.matmul(state, w_hh.t())
    h = torch.tanh(pre) if mode == "RNN_TANH" else torch.relu(pre)
    return h, h


def _keep(mask, new, old):
    """``new`` where ``mask`` (``[B, 1]``) holds, else ``old``; states may
    be ``(h, c)`` pairs."""
    if isinstance(new, tuple):
        return tuple(_keep(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask, new, old)


def _time_loop(step, xs, state, reverse, mask):
    """``step(x_t, state) -> (state, out)`` over ``xs`` ``[T, ...]``, forward
    or in reverse; ``mask`` ``[T, B, 1]`` (or None) freezes the state and
    zeroes the output of the steps past each sequence's length. Returns the
    outputs stacked ``[T, B, ...]`` in time order and the last state."""
    T = xs.shape[0]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new, out = step(xs[t], state)
        if mask is not None:
            new = _keep(mask[t], new, state)
            out = torch.where(mask[t], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
        state, outs[t] = new, out
    return torch.stack(outs), state


def _time_mask(sequence_length, T, device):
    """``[T, B, 1]`` bool: step t is within sequence b's length."""
    if sequence_length is None:
        return None
    lens = sequence_length.to(device)
    return (torch.arange(T, device=device)[:, None] < lens[None, :])[..., None]


class RNNCellBase(ParamLayer, nn.Module):
    """A cell's parameters (``weight_ih [gates * H, in]``, ``weight_hh
    [gates * H, H]`` and their biases, ``Uniform(±1/sqrt(H))``) and its
    initial states."""
    _mode = None

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        nn.Module.__init__(self)
        self.input_size, self.hidden_size = input_size, hidden_size
        g = _GATES[self._mode] * hidden_size
        init = Uniform(-1.0 / math.sqrt(hidden_size),
                       1.0 / math.sqrt(hidden_size))
        self.create_parameter("weight_ih", [g, input_size], weight_ih_attr,
                              default_initializer=init)
        self.create_parameter("weight_hh", [g, hidden_size], weight_hh_attr,
                              default_initializer=init)
        self.create_parameter("bias_ih", [g], bias_ih_attr, is_bias=True,
                              default_initializer=init)
        self.create_parameter("bias_hh", [g], bias_hh_attr, is_bias=True,
                              default_initializer=init)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``[B, hidden_size]`` filled with ``init_value``, B read from
        ``batch_ref``'s dimension ``batch_dim_idx``."""
        B = batch_ref.shape[batch_dim_idx]
        dt = getattr(torch, dtype) if isinstance(dtype, str) else (
            dtype or batch_ref.dtype)
        return torch.full((B, self.hidden_size), init_value, dtype=dt,
                          device=batch_ref.device)

    def _step(self, x, state):
        xw = _project(self._mode, x, self.weight_ih, self.bias_ih,
                      self.bias_hh)
        return _recur(self._mode, xw, state, self.weight_hh, self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or relu;
    returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        self._mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        new, out = self._step(inputs, states)
        return out, new


class LSTMCell(RNNCellBase):
    """Returns ``(h', (h', c'))``; ``states`` is ``(h, c)``."""
    _mode = "LSTM"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            states = (h, h)
        new, out = self._step(inputs, tuple(states))
        return out, new


class GRUCell(RNNCellBase):
    """Returns ``(h', h')``."""
    _mode = "GRU"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        new, out = self._step(inputs, states)
        return out, new


class RNN(nn.Module):
    """Runs ``cell`` over the time dimension (``is_reverse``: last step
    first); returns the outputs in time order and the final states. With
    ``sequence_length`` the steps past each sequence's length keep its
    state and output zeros."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        states = initial_states
        if states is None:  # the cell's own zeros, made once for the mask
            ref = self.cell.get_initial_states(xs[0])
            states = (ref, ref) if isinstance(self.cell, LSTMCell) else ref
        mask = _time_mask(sequence_length, xs.shape[0], xs.device)

        def step(x, state):
            out, new = self.cell(x, state)
            return new, out

        outs, states = _time_loop(step, xs, states, self.is_reverse, mask)
        return (outs if self.time_major else outs.transpose(0, 1)), states


class _RNNBase(ParamLayer, nn.Module):
    """``num_layers`` layers of one or two directions (``direction``
    "forward", or "bidirect" / "bidirectional"); inputs ``[B, T, in]``
    (``[T, B, in]`` when ``time_major``); returns the outputs ``[B, T, D *
    H]`` and the final states ``[L * D, B, H]`` (``(h, c)`` for LSTM)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        nn.Module.__init__(self)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction {direction!r} (expected forward | "
                             "bidirect | bidirectional)")
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout = dropout
        self.bidirect = direction != "forward"
        self.num_directions = 2 if self.bidirect else 1
        g = _GATES[mode] * hidden_size
        init = Uniform(-1.0 / math.sqrt(hidden_size),
                       1.0 / math.sqrt(hidden_size))
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for d in range(self.num_directions):
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                self.create_parameter("weight_ih" + sfx, [g, in_size],
                                      weight_ih_attr,
                                      default_initializer=init)
                self.create_parameter("weight_hh" + sfx, [g, hidden_size],
                                      weight_hh_attr,
                                      default_initializer=init)
                self.create_parameter("bias_ih" + sfx, [g], bias_ih_attr,
                                      is_bias=True, default_initializer=init)
                self.create_parameter("bias_hh" + sfx, [g], bias_hh_attr,
                                      is_bias=True, default_initializer=init)
        self.dropouts = nn.ModuleList(
            Dropout(dropout) for _ in range(num_layers - 1))

    def _weights(self, layer, d):
        sfx = f"_l{layer}" + ("_reverse" if d else "")
        return [getattr(self, n + sfx) for n in
                ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        mode, H = self.mode, self.hidden_size
        L, D = self.num_layers, self.num_directions
        is_lstm = mode == "LSTM"
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        T, B = xs.shape[0], xs.shape[1]
        if initial_states is None:
            zeros = xs.new_zeros(L * D, B, H)
            h0, c0 = zeros, zeros
        elif is_lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None
        mask = _time_mask(sequence_length, T, xs.device)
        h_last, c_last = [], []
        layer_in = xs
        for layer in range(L):
            outs = []
            for d in range(D):
                w_ih, w_hh, b_ih, b_hh = self._weights(layer, d)
                k = layer * D + d
                xw = _project(mode, layer_in, w_ih, b_ih, b_hh)
                state = (h0[k], c0[k]) if is_lstm else h0[k]

                def step(x, s, w_hh=w_hh, b_hh=b_hh):
                    return _recur(mode, x, s, w_hh, b_hh)

                out, state = _time_loop(step, xw, state, d == 1, mask)
                outs.append(out)
                h_last.append(state[0] if is_lstm else state)
                if is_lstm:
                    c_last.append(state[1])
            layer_in = torch.cat(outs, -1) if D == 2 else outs[0]
            if layer < L - 1:
                layer_in = self.dropouts[layer](layer_in)
        out = layer_in if self.time_major else layer_in.transpose(0, 1)
        h = torch.stack(h_last)
        return (out, (h, torch.stack(c_last))) if is_lstm else (out, h)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

"""Recurrent layers.

Counterpart: ``paddle_tpu/nn/layer/rnn.py``: the cell steps (:22-52),
the registered multi-output op ``rnn_scan`` (:57-106), ``SimpleRNN``,
``LSTM`` and ``GRU`` over ``_RNNBase`` (:109-203), the cells
``LSTMCell``, ``GRUCell`` and ``SimpleRNNCell`` with their registered
ops ``lstm_cell``, ``gru_cell`` and ``simple_rnn_cell`` (:206-307) and
the generic driver ``RNN`` (:310-331).

The reference scans each (layer, direction) with ``lax.scan``; here
``rnn_scan`` is a loop over the time steps in PyTorch (cuDNN's RNN is
left for later speed work), with the reference's gates and order: LSTM
gates split i, f, g, o; GRU r, z, c (``n = tanh(x_c + r·(h·W_hc +
b_hc))``); the reverse direction runs over the whole flipped sequence and
its outputs are flipped back; a bidirectional layer's output is the two
directions concatenated. The input projection of every step is one
matmul before the loop; each step adds ``h·W_hᵀ`` and then the biases,
in the reference's order. ``sequence_length`` and the inter-layer
``dropout`` are accepted and unused, as in the reference. The weights
keep the reference's names and layouts (``weight_ih_l{k}[_reverse]``
[gates·hidden, in], ``weight_hh_l…``, ``bias_ih_l…``, ``bias_hh_l…``,
each from Uniform(±1/sqrt(hidden))), so ``load_numpy`` carries them.
"""
from __future__ import annotations

import math

import torch

from ..._device import DeviceLike, resolve_device
from ...core.dispatch import register_op
from ...core.tensor import to_plain
from ...ops import stack, transpose
from ..initializer import Uniform
from .layers import Layer

__all__ = ["GRU", "GRUCell", "LSTM", "LSTMCell", "RNN", "SimpleRNN",
           "SimpleRNNCell"]


def _cell_step_lstm(params, h, c, xw):
    """One LSTM step; ``xw`` is the step's input projection x·W_iᵀ."""
    _, wh, bi, bh = params
    gates = xw + h @ wh.T
    if bi is not None:
        gates = gates + bi + bh
    i, f, g, o = gates.chunk(4, -1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    return o * torch.tanh(c2), c2


def _cell_step_gru(params, h, xw):
    _, wh, bi, bh = params
    gi = xw if bi is None else xw + bi
    gh = h @ wh.T
    if bh is not None:
        gh = gh + bh
    ir, iz, ic = gi.chunk(3, -1)
    hr, hz, hc = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(ic + r * hc)
    return (1 - z) * n + z * h


def _cell_step_simple(params, h, xw, activation):
    _, wh, bi, bh = params
    pre = xw + h @ wh.T
    if bi is not None:
        pre = pre + bi + bh
    return torch.tanh(pre) if activation == "tanh" else torch.relu(pre)


@register_op("rnn_scan", multi_out=True)
def _rnn_scan(x, init_h, init_c, weights, mode, num_layers, bidirectional,
              activation):
    """x [B, T, I] (batch first); weights a tuple of (w_ih, w_hh, b_ih,
    b_hh) per (layer, direction); returns (out [B, T, D·H], h_n [L·D, B,
    H], c_n)."""
    num_dirs = 2 if bidirectional else 1
    h_all, c_all = [], []
    layer_in = x
    for layer in range(num_layers):
        outs = []
        for d in range(num_dirs):
            params = weights[layer * num_dirs + d]
            params = tuple(None if p is None else p.to(x.dtype)
                           for p in params)
            h = init_h[layer * num_dirs + d]
            seq = layer_in if d == 0 else layer_in.flip(1)
            xw = seq.transpose(0, 1) @ params[0].T      # [T, B, G·H]
            ys = []
            if mode == "LSTM":
                c = init_c[layer * num_dirs + d]
                for xt in xw:
                    h, c = _cell_step_lstm(params, h, c, xt)
                    ys.append(h)
                c_all.append(c)
            elif mode == "GRU":
                for xt in xw:
                    h = _cell_step_gru(params, h, xt)
                    ys.append(h)
            else:
                for xt in xw:
                    h = _cell_step_simple(params, h, xt, activation)
                    ys.append(h)
            h_all.append(h)
            ys = torch.stack(ys, 1)                     # [B, T, H]
            outs.append(ys if d == 0 else ys.flip(1))
        layer_in = torch.cat(outs, -1) if num_dirs == 2 else outs[0]
    h_n = torch.stack(h_all, 0)
    c_n = torch.stack(c_all, 0) if c_all else torch.zeros_like(h_n)
    return layer_in, h_n, c_n


class _RNNBase(Layer):
    mode = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device: DeviceLike = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        gate_mult = {"LSTM": 4, "GRU": 3, "RNN": 1}[self.mode]
        std = 1.0 / math.sqrt(hidden_size)
        dev = resolve_device(device)
        self._param_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = (input_size if layer == 0
                           else hidden_size * self.num_directions)
                suffix = f"{layer}" + ("_reverse" if d == 1 else "")
                for kind, shape, attr, is_bias in (
                        ("weight_ih", [gate_mult * hidden_size, in_size],
                         weight_ih_attr, False),
                        ("weight_hh", [gate_mult * hidden_size, hidden_size],
                         weight_hh_attr, False),
                        ("bias_ih", [gate_mult * hidden_size], bias_ih_attr,
                         True),
                        ("bias_hh", [gate_mult * hidden_size], bias_hh_attr,
                         True)):
                    self.add_parameter(f"{kind}_l{suffix}",
                                       self.create_parameter(
                                           shape, attr=attr, is_bias=is_bias,
                                           default_initializer=Uniform(
                                               -std, std), device=dev))
                self._param_names.append(suffix)

    def _weights(self):
        return tuple(tuple(self._parameters[f"{kind}_l{suffix}"]
                           for kind in ("weight_ih", "weight_hh", "bias_ih",
                                        "bias_hh"))
                     for suffix in self._param_names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if self.time_major:
            x = transpose(x, [1, 0, 2])
        b = x.shape[0]
        n_state = self.num_layers * self.num_directions
        if initial_states is None:
            h0 = c0 = torch.zeros((n_state, b, self.hidden_size),
                                  dtype=torch.float32,
                                  device=to_plain(x).device)
        elif self.mode == "LSTM":
            h0, c0 = initial_states
        else:
            h0 = c0 = initial_states
        out, h_n, c_n = _rnn_scan(x, h0, c0, self._weights(), self.mode,
                                  self.num_layers, self.bidirectional,
                                  self.activation)
        if self.time_major:
            out = transpose(out, [1, 0, 2])
        if self.mode == "LSTM":
            return out, (h_n, c_n)
        return out, h_n


class SimpleRNN(_RNNBase):
    mode = "RNN"


class LSTM(_RNNBase):
    mode = "LSTM"


class GRU(_RNNBase):
    mode = "GRU"


def _cell_params(layer, gates, input_size, hidden_size, attrs, device):
    std = 1.0 / math.sqrt(hidden_size)
    for name, shape, attr, is_bias in (
            ("weight_ih", [gates * hidden_size, input_size], attrs[0], False),
            ("weight_hh", [gates * hidden_size, hidden_size], attrs[1],
             False),
            ("bias_ih", [gates * hidden_size], attrs[2], True),
            ("bias_hh", [gates * hidden_size], attrs[3], True)):
        setattr(layer, name, layer.create_parameter(
            shape, attr=attr, is_bias=is_bias,
            default_initializer=Uniform(-std, std), device=device))


def _zero_state(inputs, hidden_size):
    x = to_plain(inputs)
    return torch.zeros((x.shape[0], hidden_size), dtype=torch.float32,
                       device=x.device)


class LSTMCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device: DeviceLike = None):
        super().__init__()
        self.hidden_size = hidden_size
        _cell_params(self, 4, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr), resolve_device(device))

    def forward(self, inputs, states=None):
        if states is None:
            states = (_zero_state(inputs, self.hidden_size),
                      _zero_state(inputs, self.hidden_size))
        h, c = states
        h2, c2 = _lstm_cell_op(inputs, h, c, self.weight_ih, self.weight_hh,
                               self.bias_ih, self.bias_hh)
        return h2, (h2, c2)


@register_op("lstm_cell", multi_out=True)
def _lstm_cell_op(x, h, c, wi, wh, bi, bh):
    return _cell_step_lstm((wi, wh, bi, bh), h, c, x @ wi.T)


class GRUCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device: DeviceLike = None):
        super().__init__()
        self.hidden_size = hidden_size
        # the reference's GRUCell takes no attributes (:258-266)
        _cell_params(self, 3, input_size, hidden_size, (None,) * 4,
                     resolve_device(device))

    def forward(self, inputs, states=None):
        if states is None:
            states = _zero_state(inputs, self.hidden_size)
        h2 = _gru_cell_op(inputs, states, self.weight_ih, self.weight_hh,
                          self.bias_ih, self.bias_hh)
        return h2, h2


@register_op("gru_cell")
def _gru_cell_op(x, h, wi, wh, bi, bh):
    return _cell_step_gru((wi, wh, bi, bh), h, x @ wi.T)


class SimpleRNNCell(Layer):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device: DeviceLike = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, 1, input_size, hidden_size, (None,) * 4,
                     resolve_device(device))

    def forward(self, inputs, states=None):
        if states is None:
            states = _zero_state(inputs, self.hidden_size)
        h2 = _simple_cell_op(inputs, states, self.weight_ih, self.weight_hh,
                             self.bias_ih, self.bias_hh, self.activation)
        return h2, h2


@register_op("simple_rnn_cell")
def _simple_cell_op(x, h, wi, wh, bi, bh, activation):
    return _cell_step_simple((wi, wh, bi, bh), h, x @ wi.T, activation)


class RNN(Layer):
    """Runs ``cell`` over the time steps (``paddle.nn.RNN``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if self.time_major:
            x = transpose(x, [1, 0, 2])
        steps = x.shape[1]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outs = []
        states = initial_states
        for t in order:
            out, states = self.cell(x[:, t], states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        out = stack(outs, axis=1)
        if self.time_major:
            out = transpose(out, [1, 0, 2])
        return out, states

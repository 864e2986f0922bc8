"""Recurrent layers: port of ``paddle_tpu/nn/layer/rnn.py``.

- ``SimpleRNN``, ``LSTM`` and ``GRU`` (``_RNNBase``) are torch's
  recurrent modules with the reference's surface: parameters
  ``weight_ih_l{k}{_reverse}``, ``weight_hh_l{k}...``, ``bias_ih_l{k}...``
  and ``bias_hh_l{k}...`` in the reference's order (layer, then
  direction), gates ``i, f, g, o`` (LSTM) and ``r, z, n`` (GRU, ``n =
  tanh(W_in x + b_in + r (W_hn h + b_hn))``), which are torch's;
  ``direction="bidirect"``, ``time_major`` (else batch first), zero
  initial states in the input's dtype.  The recurrence runs through
  torch's ``_VF`` ops (cuDNN on the card): the reference's is a
  ``lax.scan`` of XLA ops, not a Pallas kernel.  float32 on the card runs
  with cuDNN's TF32 off (``functional.conv.exact_fp32``).
- ``sequence_length`` and the inter-layer ``dropout`` are accepted and
  not applied, exactly as the reference's forward (ROADMAP.md, "Known
  differences of the vision layers").
- The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) are the
  reference's step formulas in torch ops; ``RNN`` runs any cell over
  time (reversed with ``is_reverse``) and ``BiRNN`` a forward and a
  backward cell.
Every weight and bias is drawn from ``U(+-1 / sqrt(hidden_size))``
(``nn.common.reference_init``).  Each op casts by the AMP rule under the
reference's name (``lstm``, ``gru``, ``rnn_tanh``, ``lstm_cell``, ...).
"""

from __future__ import annotations

import torch
from torch import _VF, nn

from ..amp.auto_cast import cast as _amp_cast
from .common import materialize, meta_factory
from .functional.conv import exact_fp32

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN",
           "LSTM", "GRU", "BiRNN"]

_OPS = {"LSTM": ("lstm", _VF.lstm), "GRU": ("gru", _VF.gru),
        "RNN_TANH": ("rnn_tanh", _VF.rnn_tanh)}


class RNNCellBase(nn.Module):
    def _init_params(self, input_size, hidden_size, gates, bias_ih_attr,
                     bias_hh_attr, device, dtype):
        self.hidden_size = hidden_size
        fac = meta_factory(dtype)
        gh = gates * hidden_size
        self.weight_ih = nn.Parameter(torch.empty((gh, input_size), **fac))
        self.weight_hh = nn.Parameter(torch.empty((gh, hidden_size), **fac))
        self.bias_ih = None if bias_ih_attr is False else nn.Parameter(
            torch.empty((gh,), **fac))
        self.bias_hh = None if bias_hh_attr is False else nn.Parameter(
            torch.empty((gh,), **fac))
        materialize(self, device)

    def _zeros(self, x):
        return torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                           device=x.device)


def _proj(x, h, w_ih, w_hh):
    return x @ w_ih.T, h @ w_hh.T


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        self._init_params(input_size, hidden_size, 1, bias_ih_attr,
                          bias_hh_attr, device, dtype)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        x, h, w_ih, w_hh, b_ih, b_hh = _amp_cast(
            "simple_rnn_cell", inputs, h, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        xi, hh = _proj(x, h, w_ih, w_hh)
        h = torch.tanh(xi + hh + b_ih + b_hh)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype="float32"):
        super().__init__()
        self._init_params(input_size, hidden_size, 4, bias_ih_attr,
                          bias_hh_attr, device, dtype)

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        x, h, c, w_ih, w_hh, b_ih, b_hh = _amp_cast(
            "lstm_cell", inputs, states[0], states[1], self.weight_ih,
            self.weight_hh, self.bias_ih, self.bias_hh)
        xi, hh = _proj(x, h, w_ih, w_hh)
        i, f, g, o = torch.chunk(xi + hh + (b_ih + b_hh), 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype="float32"):
        super().__init__()
        self._init_params(input_size, hidden_size, 3, bias_ih_attr,
                          bias_hh_attr, device, dtype)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        x, h, w_ih, w_hh, b_ih, b_hh = _amp_cast(
            "gru_cell", inputs, h, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        xi, hh = _proj(x, h, w_ih, w_hh)
        ri, zi, ni = torch.chunk(xi + b_ih, 3, dim=-1)
        rh, zh, nh = torch.chunk(hh + b_hh, 3, dim=-1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi + zh)
        n = torch.tanh(ni + r * nh)
        h = (1 - z) * n + z * h
        return h, h


class RNN(nn.Module):
    """A cell run over time (the reference's eager loop for custom
    cells)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outs, state = [], initial_states
        for t in order:
            out, state = self.cell(inputs.select(axis, t), state)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=axis), state


class _RNNBase(nn.RNNBase):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype="float32"):
        bidirect = direction in ("bidirect", "bidirectional")
        super().__init__(mode, input_size, hidden_size, num_layers, True,
                         not time_major, 0.0, bidirect,
                         **meta_factory(dtype))
        self.bidirect = bidirect
        self.mode = mode
        self.time_major = time_major
        self.dropout = float(dropout)      # accepted, not applied
        materialize(self, device)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        op, fn = _OPS[self.mode]
        lstm = self.mode == "LSTM"
        batch = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            z = torch.zeros((self.num_layers * (2 if self.bidirect else 1),
                             batch, self.hidden_size), dtype=inputs.dtype,
                            device=inputs.device)
            states = (z, z) if lstm else (z,)
        else:
            states = tuple(initial_states) if lstm else (initial_states,)
        x, *rest = _amp_cast(op, inputs, *states, *self._flat_weights)
        n_st = len(states)

        def run(x, *rest):
            hx = tuple(rest[:n_st]) if lstm else rest[0]
            return tuple(fn(x, hx, list(rest[n_st:]), True, self.num_layers,
                            0.0, self.training, self.bidirect,
                            not self.time_major))

        out = exact_fp32(run, x, *rest)
        if lstm:
            return out[0], (out[1], out[2])
        return out[0], out[1]


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, dtype="float32",
                 **kwargs):
        super().__init__("RNN_TANH", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, dtype="float32", **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, dtype="float32", **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)


class BiRNN(nn.Module):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, st_fw = self.fw(inputs, st_fw)
        out_bw, st_bw = self.bw(inputs, st_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)

"""Recurrent networks (port of ``svt_speechbrain_tpu/nnet/rnn.py``).

The JAX package computes its recurrences as ``lax.scan`` outside any
hand-written kernel, so here ``torch.nn.RNN``/``LSTM``/``GRU`` (cuDNN on the
card) carry them, one single-layer module per layer so that the dropout
between layers takes the step's generator (``StepRNG``) and no global RNG is
read. Gate orders agree (LSTM i, f, g, o; GRU r, z, n). torch keeps its
weights (g·H, in); the JAX trees hold ``l{k}``/``l{k}_rev`` with ``w_ih``
(in, g·H), ``w_hh`` (H, g·H), ``b_ih``, ``b_hh``, which ``convert_jax``
transposes both ways.

States are a list with one entry per layer, in the form the ``finals`` of a
forward come back in: a (B, H) tensor, ``(h, c)`` for an LSTM, and a
``(forward, backward)`` pair of those for a bidirectional layer.

``LiGRU``, ``QuasiRNN`` and ``AttentionalRNNDecoder`` are not ported yet and
raise ``NotImplementedError`` (``ROADMAP.md`` queue 1 item 19).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.dropout import dropout as _drop


class _RNNBase(nn.Module):
    TORCH = None                 # the torch.nn class of one layer

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 num_layers=1, bias=True, dropout=0.0, bidirectional=False,
                 re_init=True, **layer_kwargs):
        super().__init__()
        del re_init              # accepted and unused, as in the JAX package
        if input_size is None and input_shape is not None:
            input_size = int(math.prod(input_shape[2:]))
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.num_layers = num_layers
        self.bias = bias
        self.dropout = dropout
        self.bidirectional = bidirectional
        n_dir = 2 if bidirectional else 1
        self.layers = nn.ModuleList(
            self.TORCH(input_size if k == 0 else hidden_size * n_dir,
                       hidden_size, num_layers=1, bias=bias, batch_first=True,
                       bidirectional=bidirectional, **layer_kwargs)
            for k in range(num_layers))

    # one direction's state ↔ torch's (1, B, H) tensors
    def _to_torch(self, state):
        return state[None]

    def _from_torch(self, h_n, d):
        return h_n[d]

    def _layer_state(self, state):
        if state is None:
            return None
        dirs = state if self.bidirectional else (state,)
        parts = [self._to_torch(s) for s in dirs]
        if isinstance(parts[0], tuple):                       # LSTM (h, c)
            return tuple(torch.cat(p, dim=0) for p in zip(*parts))
        return torch.cat(parts, dim=0)

    def forward(self, x, hx=None, rng=None, train=False):
        """x: (batch, time, features) → (output, final_states). ``hx`` is a
        list of per-layer states as ``final_states`` gives them (zeros if
        None); the JAX ``__call__`` accepts and ignores it, the cells'
        step-wise form of the same weights is what honours it there.
        ``train`` with a ``StepRNG`` turns on the dropout between layers."""
        if x.dim() == 4:  # (B, T, C, F) → flatten
            x = x.reshape(x.shape[0], x.shape[1], -1)
        if hx is not None and len(hx) != self.num_layers:
            raise ValueError(f"hx holds {len(hx)} states for "
                             f"{self.num_layers} layers")
        finals = []
        for k, layer in enumerate(self.layers):
            x, h_n = layer(x, None if hx is None
                           else self._layer_state(hx[k]))
            if self.bidirectional:
                finals.append((self._from_torch(h_n, 0),
                               self._from_torch(h_n, 1)))
            else:
                finals.append(self._from_torch(h_n, 0))
            if k < self.num_layers - 1:
                x = _drop(x, self.dropout,
                          None if rng is None else rng.device, train)
        return x, finals


class RNN(_RNNBase):
    """Vanilla tanh/relu RNN (``rnn.py:105``)."""

    TORCH = nn.RNN

    def __init__(self, *args, nonlinearity="tanh", **kwargs):
        super().__init__(*args, nonlinearity="tanh" if nonlinearity == "tanh"
                         else "relu", **kwargs)


class LSTM(_RNNBase):
    """LSTM (``rnn.py:121``); gate order i, f, g, o.

    Example
    -------
    >>> import torch
    >>> lstm = LSTM(hidden_size=5, input_size=3, bidirectional=True)
    >>> out, finals = lstm(torch.ones(2, 7, 3))
    >>> out.shape                    # fwd+bwd concat
    torch.Size([2, 7, 10])
    """

    TORCH = nn.LSTM

    def _to_torch(self, state):
        h, c = state
        return h[None], c[None]

    def _from_torch(self, h_n, d):
        return h_n[0][d], h_n[1][d]


class GRU(_RNNBase):
    """GRU (``rnn.py:169``); gate order r, z, n."""

    TORCH = nn.GRU


class _CellMixin:
    """Step-wise stacked cells for autoregressive decoders (``rnn.py:523``):
    one timestep through ``num_layers`` layers of the sequence module's
    weights; states are a list per layer."""

    def __init__(self, hidden_size, input_size, num_layers=1, bias=True,
                 dropout=0.0, re_init=True, **inner_kwargs):
        super().__init__(hidden_size, input_size=input_size,
                         num_layers=num_layers, bias=bias, dropout=dropout,
                         re_init=re_init, **inner_kwargs)

    def init_states(self, batch):
        ref = self.layers[0].weight_hh_l0
        zeros = ref.new_zeros(batch, self.hidden_size)
        if isinstance(self, LSTM):
            return [(zeros, zeros) for _ in range(self.num_layers)]
        return [zeros for _ in range(self.num_layers)]

    def forward(self, x_t, states=None):
        """x_t (B, F) one frame → (out (B, H), new per-layer states)."""
        out, new_states = super().forward(x_t[:, None], states)
        return out[:, 0], new_states


class RNNCell(_CellMixin, RNN):
    """Vanilla tanh/relu RNN cell stack (``rnn.py:557``)."""


class GRUCell(_CellMixin, GRU):
    """GRU cell stack (``rnn.py:562``).

    Example
    -------
    >>> import torch
    >>> cell = GRUCell(hidden_size=4, input_size=3, num_layers=2)
    >>> out, states = cell(torch.ones(2, 3))
    >>> out.shape, len(states), states[0].shape
    (torch.Size([2, 4]), 2, torch.Size([2, 4]))
    """


class LSTMCell(_CellMixin, LSTM):
    """LSTM cell stack (``rnn.py:567``)."""


def _not_ported(name):
    class NotPorted(nn.Module):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP.md queue 1 item 19)")

    NotPorted.__name__ = NotPorted.__qualname__ = name
    NotPorted.__doc__ = (f"``{name}`` of the JAX package waits for a later "
                         f"slice; constructing it raises.")
    return NotPorted


LiGRU = _not_ported("LiGRU")
QuasiRNN = _not_ported("QuasiRNN")
AttentionalRNNDecoder = _not_ported("AttentionalRNNDecoder")
LiGRU_Layer = LiGRU
QuasiRNNLayer = QuasiRNN


def rnn_init(module):
    """Orthogonalize the recurrent (hidden→hidden) weights of every RNN
    layer under ``module``, in place (``rnn.py:572``): the Q factor of the
    (H, g·H) matrix in the JAX layout, by a float64 QR. As in the JAX
    package that factor is (H, H), so it fits a vanilla ``RNN``'s weight
    only; a gated layer (g > 1) raises."""
    found = [(name, p) for name, p in module.named_parameters()
             if ".weight_hh_l0" in "." + name]
    for name, p in found:
        if p.shape[0] != p.shape[1]:
            raise ValueError(f"{name}: the Q factor of a "
                             f"{tuple(p.t().shape)} matrix is square; only "
                             f"g = 1 (a vanilla RNN) keeps its shape")
    for _, p in found:
        q = torch.linalg.qr(p.detach().t().double().cpu())[0]   # of (H, H)
        with torch.no_grad():
            p.copy_(q.t().to(p.dtype))
    return module


def pack_padded_sequence(inputs, lengths):
    """The identity with the lengths carried alongside (``rnn.py:591``):
    masking happens in the losses and the attention."""
    return inputs, torch.as_tensor(lengths)


def pad_packed_sequence(inputs):
    """Inverse of ``pack_padded_sequence`` (``rnn.py:598``)."""
    if isinstance(inputs, tuple):
        return inputs[0]
    return inputs

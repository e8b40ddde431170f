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

``LiGRU`` (batch- or layer-normalized light GRU), ``QuasiRNN`` and the
``AttentionalRNNDecoder`` run their recurrences as a loop of eager steps:
cuDNN has no LiGRU, and the JAX package computes them with ``lax.scan`` and
Python loops outside any kernel.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.dropout import dropout as _drop
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (BatchNorm1d,
                                                          LayerNorm)


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
        # built without torch's initialisation (which reads the global
        # RNG) and zeroed: zeros until loaded or seeded, as every port leaf
        self.layers = nn.ModuleList(
            self.TORCH(input_size if k == 0 else hidden_size * n_dir,
                       hidden_size, num_layers=1, bias=bias, batch_first=True,
                       bidirectional=bidirectional, device="meta",
                       **layer_kwargs).to_empty(device="cpu")
            for k in range(num_layers))
        with torch.no_grad():
            for p in self.layers.parameters():
                p.zero_()

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


_LIGRU_ACTS = {"tanh": torch.tanh, "sin": torch.sin,
               "leaky_relu": torch.nn.functional.leaky_relu}


class _LiGRULayer(nn.Module):
    """One LiGRU layer's weights: bias-free ``w`` (in, 2H) and ``u`` (H,
    2H), and ``norm`` over the 2H projections of all frames. The JAX state
    tree keeps ``norm``'s running statistics at this layer's own path
    (``l{k}/{mean,var}``)."""

    jax_state_child = "norm"

    def __init__(self, input_size, hidden_size, normalization):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(input_size, 2 * hidden_size))
        self.u = nn.Parameter(torch.zeros(hidden_size, 2 * hidden_size))
        self.norm = (BatchNorm1d(2 * hidden_size, momentum=0.05)
                     if normalization == "batchnorm"
                     else LayerNorm(2 * hidden_size))


class LiGRU(nn.Module):
    """Light GRU (``rnn.py:188``): layers ``l0``, ``l1``, ... of bias-free
    ``w`` (in, 2H) and ``u`` (H, 2H). The ``w`` projection of every frame is
    normalized at once, before the recurrence: by a per-layer
    ``BatchNorm1d(2H, momentum=0.05)`` (``normalization="batchnorm"``; its
    running statistics are buffers, updated in training) or, for any other
    string, a ``LayerNorm(2H)`` (``rnn.py:330-333``). Gates in the order
    (candidate a, update z): h = z·h + (1-z)·act(a)·mask. A bidirectional
    layer shares ``w`` and ``u``: the flipped sequence rides the batch axis
    and its outputs are flipped back and concatenated.

    ``forward(x, hx=None, train=False, rng=None, return_state=False)``: x
    (B, T, F) (or (B, T, C, F), flattened) → (out (B, T, H·n_dir), finals,
    one (B·n_dir, H) per layer), and with ``return_state`` also the running
    statistics as the JAX state tree ({"l0": {"mean", "var"}, ...}, empty
    for layer norm). ``hx`` is (num_layers·n_dir, B, H), torch-style, or
    one (B, H) for every layer (``rnn.py:300-318``). In training with a
    ``StepRNG`` the recurrent dropout draws one (B·n_dir, H) mask a layer a
    forward from its device generator, shared by every step.

    The recurrence is a loop of eager steps (cuDNN has no LiGRU): a step
    is ``addmm``, a sigmoid, the activation (times the mask) and a
    ``lerp``, over the frames of one ``unbind``.

    Example
    -------
    >>> import torch
    >>> rnn = LiGRU(hidden_size=5, input_size=3, num_layers=2,
    ...             bidirectional=True)
    >>> out, finals = rnn(torch.ones(2, 7, 3))
    >>> out.shape, finals[0].shape
    (torch.Size([2, 7, 10]), torch.Size([4, 5]))
    """

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 num_layers=1, bias=True, dropout=0.0, bidirectional=False,
                 nonlinearity="relu", normalization="batchnorm",
                 re_init=True):
        super().__init__()
        del bias, re_init          # the projections are bias-free
        if input_size is None and input_shape is not None:
            input_size = int(math.prod(input_shape[2:]))
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.normalization = normalization
        self.nonlinearity = nonlinearity
        self.act = _LIGRU_ACTS.get(nonlinearity, torch.relu)
        n_dir = 2 if bidirectional else 1
        for k in range(num_layers):
            self.add_module(f"l{k}", _LiGRULayer(
                input_size if k == 0 else hidden_size * n_dir, hidden_size,
                normalization))

    def _hx(self, hx, b):
        n_dir = 2 if self.bidirectional else 1
        shape = (self.num_layers, n_dir * b, self.hidden_size)
        if hx.dim() == 2:
            hx = hx.expand(self.num_layers, *hx.shape)
            if self.bidirectional:
                hx = torch.cat([hx, hx], dim=1)
        elif self.bidirectional:
            hx = hx.reshape(shape)
        if tuple(hx.shape) != shape:
            raise ValueError(f"hx shape {tuple(hx.shape)} incompatible with "
                             f"({self.num_layers}[*n_dir], {b}, "
                             f"{self.hidden_size})")
        return hx

    def _recurrence(self, u, w, h, mask):
        """h_t over the normalized projections ``w`` (B', T, 2H)."""
        outs = []
        for w_t in w.unbind(1):     # one backward op, not a fill a step
            at, zt = torch.addmm(w_t, h, u).chunk(2, dim=-1)
            cand = self.act(at)
            if mask is not None:
                cand = cand * mask
            h = torch.lerp(cand, h, torch.sigmoid(zt))
            outs.append(h)
        return torch.stack(outs, dim=1), h

    def forward(self, x, hx=None, train=False, rng=None, return_state=False):
        if x.dim() == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)
        b = x.shape[0]
        if hx is not None:
            hx = self._hx(hx.to(x.dtype), b)
        finals = []
        for k in range(self.num_layers):
            layer = getattr(self, f"l{k}")
            inp = torch.cat([x, x.flip(1)], dim=0) if self.bidirectional \
                else x
            w = inp @ layer.w.to(x.dtype)
            w = (layer.norm(w, train=train)
                 if isinstance(layer.norm, BatchNorm1d) else layer.norm(w))
            h0 = (x.new_zeros(inp.shape[0], self.hidden_size) if hx is None
                  else hx[k])
            mask = None
            if train and rng is not None and self.dropout > 0:
                mask = _drop(x.new_ones(inp.shape[0], self.hidden_size),
                             self.dropout, rng.device, True)
            outs, final = self._recurrence(layer.u.to(x.dtype), w, h0, mask)
            if self.bidirectional:
                outs = torch.cat([outs[:b], outs[b:].flip(1)], dim=-1)
            x = outs
            finals.append(final)
        if not return_state:
            return x, finals
        state = {}
        if self.normalization == "batchnorm":
            state = {f"l{k}": {"mean": getattr(self, f"l{k}").norm.mean,
                               "var": getattr(self, f"l{k}").norm.var}
                     for k in range(self.num_layers)}
        return x, finals, state


class QuasiRNN(nn.Module):
    """Quasi-RNN (``rnn.py:352``): per layer ``l{k}``, a ``Linear`` of the
    current and previous frames to 3·H·n_dir gates (z tanh, f and o
    sigmoid), then the recurrent pooling c = f·c + (1-f)·z and h = o·c;
    a bidirectional layer pools its second halves backwards.
    ``forward(x, hx=None)`` → (out, None); ``zoneout`` is accepted and, as
    in the JAX module, not applied.

    Example
    -------
    >>> import torch
    >>> out, _ = QuasiRNN(4, input_size=3, bidirectional=True)(torch.ones(2, 6, 3))
    >>> out.shape
    torch.Size([2, 6, 8])
    """

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 num_layers=1, zoneout=0.0, bidirectional=False, **kwargs):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = int(math.prod(input_shape[2:]))
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        n_dir = 2 if bidirectional else 1
        for k in range(num_layers):
            in_size = input_size if k == 0 else hidden_size * n_dir
            self.add_module(f"l{k}", Linear(3 * hidden_size * n_dir,
                                            in_size * 2))

    @staticmethod
    def _pool(z, f):
        c = torch.zeros_like(z[:, 0])
        cs = []
        for z_t, f_t in zip(z.unbind(1), f.unbind(1)):
            c = torch.lerp(z_t, c, f_t)
            cs.append(c)
        return torch.stack(cs, dim=1)

    def forward(self, x, hx=None):
        for k in range(self.num_layers):
            prev = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
            y = getattr(self, f"l{k}")(torch.cat([x, prev], dim=-1))
            z, f, o = y.chunk(3, dim=-1)
            z, f, o = torch.tanh(z), torch.sigmoid(f), torch.sigmoid(o)
            if self.bidirectional:
                zf, zb = z.chunk(2, dim=-1)
                ff, fb = f.chunk(2, dim=-1)
                of, ob = o.chunk(2, dim=-1)
                cb = self._pool(zb.flip(1), fb.flip(1)).flip(1)
                x = torch.cat([of * self._pool(zf, ff), ob * cb], dim=-1)
            else:
                x = o * self._pool(z, f)
        return x, None


class AttentionalRNNDecoder(nn.Module):
    """RNN/GRU/LSTM decoder with content, location-aware or key-value
    attention (``rnn.py:406``): ``rnn`` a cell stack over input_size +
    attn_dim, ``attn`` emitting an attn_dim-wide context, and ``proj`` of
    cat(context, cell output) to hidden_size.

    ``forward_step(inp_t, hs, context, enc_states, enc_len,
    attn_state=None, train=False, rng=None, enc_h=None)`` → (dec_out, hs,
    context, weights, attn_state): ``attn_state`` threads the
    location-aware attention's previous weights (None for the others);
    ``enc_h`` is the attention's encoder projection if the caller has it.
    In training with a ``StepRNG`` the cell input takes dropout at
    ``dropout`` from its device generator.

    ``forward(inp, enc_states, wav_len, train=False, rng=None)`` decodes
    teacher-forced: inp (B, U, E), ``wav_len`` relative, enc_len =
    round(T · wav_len) (half to even), the encoder projection computed
    once; → (outputs (B, U, hidden), weights (B, U, T) or (B, U, 1, T) for
    key-value attention).

    Example
    -------
    >>> import torch
    >>> dec = AttentionalRNNDecoder("gru", "location", hidden_size=7,
    ...                             attn_dim=5, num_layers=1, enc_dim=10,
    ...                             input_size=6, channels=2, kernel_size=3)
    >>> out, w = dec(torch.ones(2, 4, 6), torch.ones(2, 9, 10), torch.ones(2))
    >>> out.shape, w.shape
    (torch.Size([2, 4, 7]), torch.Size([2, 4, 9]))
    """

    def __init__(self, rnn_type, attn_type, hidden_size, attn_dim,
                 num_layers, enc_dim, input_size, nonlinearity="relu",
                 re_init=True, normalization="batchnorm", scaling=1.0,
                 channels=None, kernel_size=None, bias=True, dropout=0.0):
        super().__init__()
        from svt_speechbrain_tpu_torch.nnet.attention import (
            ContentBasedAttention, KeyValueAttention, LocationAwareAttention)

        self.rnn_type = rnn_type.lower()
        self.attn_type = attn_type.lower()
        self.hidden_size = hidden_size
        self.attn_dim = attn_dim
        self.num_layers = num_layers
        self.dropout = dropout
        self.proj = Linear(hidden_size, hidden_size + attn_dim)
        if self.attn_type == "content":
            self.attn = ContentBasedAttention(
                enc_dim=enc_dim, dec_dim=hidden_size, attn_dim=attn_dim,
                output_dim=attn_dim, scaling=scaling)
        elif self.attn_type == "location":
            self.attn = LocationAwareAttention(
                enc_dim=enc_dim, dec_dim=hidden_size, attn_dim=attn_dim,
                output_dim=attn_dim, conv_channels=channels,
                kernel_size=kernel_size, scaling=scaling)
        elif self.attn_type == "keyvalue":
            self.attn = KeyValueAttention(
                enc_dim=enc_dim, dec_dim=hidden_size, attn_dim=attn_dim,
                output_dim=attn_dim)
        else:
            raise ValueError(f"{self.attn_type} is not implemented.")
        cell_cls = {"rnn": RNNCell, "gru": GRUCell, "lstm": LSTMCell}[
            self.rnn_type]
        kwargs = dict(hidden_size=hidden_size,
                      input_size=input_size + attn_dim,
                      num_layers=num_layers, bias=bias,
                      dropout=0.0 if num_layers == 1 else dropout)
        if self.rnn_type == "rnn":
            kwargs["nonlinearity"] = nonlinearity
        self.rnn = cell_cls(**kwargs)

    def _enc_h(self, enc_states):
        if self.attn_type == "keyvalue":
            return None
        return self.attn.mlp_enc(enc_states)

    def forward_step(self, inp_t, hs, context, enc_states, enc_len,
                     attn_state=None, train=False, rng=None, enc_h=None):
        """One decode step (``rnn.py:466``): input (B, E) and the previous
        context (B, attn_dim)."""
        if hs is None:
            hs = self.rnn.init_states(inp_t.shape[0])
        cell_inp = torch.cat([inp_t, context.to(inp_t.dtype)], dim=-1)
        if rng is not None:
            cell_inp = _drop(cell_inp, self.dropout, rng.device, train)
        cell_out, hs = self.rnn(cell_inp, hs)
        if self.attn_type == "location":
            context, w = self.attn(enc_states, enc_len, cell_out,
                                   prev_attn=attn_state, enc_h=enc_h)
            attn_state = w
        elif self.attn_type == "content":
            context, w = self.attn(enc_states, enc_len, cell_out,
                                   enc_h=enc_h)
        else:
            context, w = self.attn(enc_states, enc_len, cell_out)
        dec_out = self.proj(torch.cat([context, cell_out], dim=1))
        return dec_out, hs, context, w, attn_state

    def forward(self, inp, enc_states, wav_len, train=False, rng=None):
        t = enc_states.shape[1]
        wav_len = torch.as_tensor(wav_len, device=enc_states.device)
        enc_len = torch.round(t * wav_len.float()).long()
        context = enc_states.new_zeros(inp.shape[0], self.attn_dim)
        enc_h = self._enc_h(enc_states)
        hs, attn_state = None, None
        outs, attns = [], []
        for inp_t in inp.unbind(1):
            out, hs, context, w, attn_state = self.forward_step(
                inp_t, hs, context, enc_states, enc_len, attn_state,
                train=train, rng=rng, enc_h=enc_h)
            outs.append(out)
            attns.append(w)
        return torch.stack(outs, dim=1), torch.stack(attns, dim=1)


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

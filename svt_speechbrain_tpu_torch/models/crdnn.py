"""CRDNN and VanillaNN (port of ``svt_speechbrain_tpu/models/crdnn.py``):
convolutional blocks, a recurrent stack (LSTM, GRU or LiGRU) and dense
blocks, SpeechBrain's CRDNN acoustic model."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import Conv2d
from svt_speechbrain_tpu_torch.nnet.dropout import dropout as _dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (BatchNorm1d,
                                                          LayerNorm)
from svt_speechbrain_tpu_torch.nnet.pooling import Pooling2d
from svt_speechbrain_tpu_torch.nnet.rnn import GRU, LSTM, LiGRU


def _generator(rng):
    return None if rng is None else rng.device


class CNNBlock(nn.Module):
    """Two reflect-padded "same" ``Conv2d``s, each followed by a
    ``LayerNorm`` over the channels and a leaky ReLU, then max pooling of
    the frequency axis by ``pooling_size[-1]`` and dropout
    (``crdnn.py:19``). Input (B, T, F, C)."""

    def __init__(self, channels, in_channels, kernel_size=(3, 3),
                 pooling_size=(2, 2), dropout=0.15):
        super().__init__()
        self.conv1 = Conv2d(channels, kernel_size, in_channels,
                            padding="same", padding_mode="reflect")
        self.norm1 = LayerNorm(channels)
        self.conv2 = Conv2d(channels, kernel_size, channels, padding="same",
                            padding_mode="reflect")
        self.norm2 = LayerNorm(channels)
        self.pool = Pooling2d("max", (1, pooling_size[-1]))
        self.dropout = dropout

    def forward(self, x, rng=None, train=False):
        x = F.leaky_relu(self.norm1(self.conv1(x)))
        x = F.leaky_relu(self.norm2(self.conv2(x)))
        return _dropout(self.pool(x), self.dropout, _generator(rng), train)


class DNNBlock(nn.Module):
    """``Linear`` + ``BatchNorm1d`` + leaky ReLU + dropout
    (``crdnn.py:50``). The JAX state tree keeps the norm's running
    statistics at the block's own path."""

    jax_state_child = "norm"

    def __init__(self, neurons, input_size, dropout=0.15):
        super().__init__()
        self.linear = Linear(neurons, input_size)
        self.norm = BatchNorm1d(neurons)
        self.dropout = dropout

    def forward(self, x, rng=None, train=False):
        x = F.leaky_relu(self.norm(self.linear(x), train=train))
        return _dropout(x, self.dropout, _generator(rng), train)


class CRDNN(nn.Module):
    """CNN blocks → LSTM/GRU/LiGRU → DNN blocks (``crdnn.py:74``): (B, T,
    F) → (B, T', dnn_neurons), T' = T // time_pooling_size with
    ``time_pooling``. Children ``cnn{i}``, ``rnn``, ``dnn{i}``, named as the
    JAX tree. The running statistics (the DNN blocks' and a batch-normed
    LiGRU's) are buffers, updated in training; ``rng`` is a ``StepRNG``
    whose device generator draws every dropout mask.

    Example
    -------
    >>> import torch
    >>> model = CRDNN(input_size=40, cnn_channels=(16, 32), rnn_layers=1,
    ...               rnn_neurons=32, dnn_neurons=24)
    >>> model(torch.ones(2, 20, 40)).shape
    torch.Size([2, 20, 24])
    """

    def __init__(self, input_size, cnn_blocks=2, cnn_channels=(128, 256),
                 cnn_kernelsize=(3, 3), time_pooling=False,
                 time_pooling_size=2, freq_pooling_size=2, rnn_class="lstm",
                 rnn_layers=4, rnn_neurons=512, rnn_bidirectional=True,
                 dnn_blocks=2, dnn_neurons=512, dropout=0.15):
        super().__init__()
        self.input_size = input_size
        self.cnn_blocks_n = cnn_blocks
        self.dnn_blocks_n = dnn_blocks
        self.time_pooling = time_pooling
        self.time_pooling_size = time_pooling_size
        in_ch, feat = 1, input_size
        for i in range(cnn_blocks):
            self.add_module(f"cnn{i}", CNNBlock(
                cnn_channels[i], in_ch, cnn_kernelsize,
                (1, freq_pooling_size), dropout))
            in_ch = cnn_channels[i]
            feat = feat // freq_pooling_size
        self.time_pool = Pooling2d("max", (time_pooling_size, 1))
        rnn_cls = {"lstm": LSTM, "gru": GRU, "ligru": LiGRU}[rnn_class]
        self.rnn = rnn_cls(rnn_neurons, input_size=feat * in_ch,
                           num_layers=rnn_layers,
                           bidirectional=rnn_bidirectional, dropout=dropout)
        in_size = rnn_neurons * (2 if rnn_bidirectional else 1)
        for i in range(dnn_blocks):
            self.add_module(f"dnn{i}", DNNBlock(dnn_neurons, in_size,
                                                dropout))
            in_size = dnn_neurons

    def forward(self, x, rng=None, train=False):
        h = x[..., None]
        for i in range(self.cnn_blocks_n):
            h = getattr(self, f"cnn{i}")(h, rng=rng, train=train)
        if self.time_pooling:
            h = self.time_pool(h)
        h = h.reshape(h.shape[0], h.shape[1], -1)
        h = self.rnn(h, rng=rng, train=train)[0]
        for i in range(self.dnn_blocks_n):
            h = getattr(self, f"dnn{i}")(h, rng=rng, train=train)
        return h


class VanillaNN(nn.Module):
    """Dense layers ``0``, ``1``, ... with a leaky ReLU (or ReLU) after
    each (``crdnn.py:164``).

    Example
    -------
    >>> import torch
    >>> VanillaNN(input_size=8, dnn_neurons=4)(torch.ones(2, 3, 8)).shape
    torch.Size([2, 3, 4])
    """

    def __init__(self, input_size, dnn_blocks=2, dnn_neurons=512,
                 activation="leaky_relu"):
        super().__init__()
        in_size = input_size
        for i in range(dnn_blocks):
            self.add_module(str(i), Linear(dnn_neurons, in_size))
            in_size = dnn_neurons
        self.activation = activation

    def forward(self, x):
        act = F.leaky_relu if self.activation == "leaky_relu" else torch.relu
        for block in self.children():
            x = act(block(x))
        return x


CNN_Block = CNNBlock
DNN_Block = DNNBlock

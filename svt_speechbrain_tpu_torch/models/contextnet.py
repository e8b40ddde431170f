"""ContextNet and ESPnetVGG encoder lobes (port of
``svt_speechbrain_tpu/models/contextnet.py``). ContextNet's BatchNorm
statistics are buffers, updated by a training forward and used in eval;
the JAX state tree keeps each at the norm's own path (``{i}/norm{j}``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.activations import Swish
from svt_speechbrain_tpu_torch.nnet.cnn import (Conv1d, Conv2d,
                                                DepthwiseSeparableConv1d)
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from svt_speechbrain_tpu_torch.nnet.pooling import Pooling2d
from svt_speechbrain_tpu_torch.nnet.rnn import LSTM


class SEmodule(nn.Module):
    """Squeeze-excitation over the time-averaged channels
    (``contextnet.py:18``): ``lin1``, ReLU, ``lin2``, sigmoid, a gate on
    every frame."""

    def __init__(self, inner_dim, input_size):
        super().__init__()
        self.lin1 = Linear(inner_dim, input_size)
        self.lin2 = Linear(input_size, inner_dim)

    def forward(self, x):
        s = torch.relu(self.lin1(x.mean(dim=1, keepdim=True)))
        return x * torch.sigmoid(self.lin2(s))


class ContextNetBlock(nn.Module):
    """Depthwise-separable convs (``conv{i}``, the last one strided), each
    with a ``BatchNorm1d`` (``norm{i}``) and Swish, then ``SEmodule`` and a
    residual through a bias-free reflect "same" 1x1 conv (``res``), added
    when the shapes match (``contextnet.py:37``)."""

    def __init__(self, n_convs, channels, in_channels, kernel_size=3,
                 stride=1, residual=True, se_inner=64):
        super().__init__()
        self.n_convs = n_convs
        ch = in_channels
        for i in range(n_convs):
            self.add_module(f"conv{i}", DepthwiseSeparableConv1d(
                channels, kernel_size, ch,
                stride=stride if i == n_convs - 1 else 1))
            self.add_module(f"norm{i}", BatchNorm1d(channels))
            ch = channels
        self.se = SEmodule(channels, channels)
        self.residual = residual
        self.stride = stride
        if residual:
            self.res = Conv1d(channels, 1, in_channels, stride=stride,
                              padding="same", padding_mode="reflect",
                              bias=False)
        self.swish = Swish()

    def forward(self, x, train=False):
        residual = x
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i}")(x)
            x = self.swish(getattr(self, f"norm{i}")(x, train=train))
        x = self.se(x)
        if self.residual:
            res = self.res(residual)
            if res.shape == x.shape:
                x = x + res
        return x


class ContextNet(nn.Module):
    """ContextNet encoder (``contextnet.py:87``): ``num_blocks``
    ``ContextNetBlock``s (children ``0``, ``1``, ...) on the small
    variant's channel and stride plan.

    Example
    -------
    >>> import torch
    >>> net = ContextNet(input_size=40, out_channels=64,
    ...                  conv_channels=[32, 32, 32, 32, 64],
    ...                  num_blocks=5, num_layers=2)
    >>> net(torch.ones(2, 16, 40)).shape
    torch.Size([2, 16, 64])
    """

    def __init__(self, input_size, out_channels=640, conv_channels=None,
                 kernel_size=3, strides=None, num_blocks=5, num_layers=2,
                 se_inner=64):
        super().__init__()
        conv_channels = conv_channels or ([128] * (num_blocks - 1)
                                          + [out_channels])
        strides = strides or [1] * num_blocks
        ch = input_size
        for i in range(num_blocks):
            self.add_module(str(i), ContextNetBlock(
                num_layers, conv_channels[i], ch, kernel_size, strides[i]))
            ch = conv_channels[i]

    def forward(self, x, train=False):
        for block in self.children():
            x = block(x, train=train)
        return x


class ESPnetVGG(nn.Module):
    """VGG2L frontend + LSTM (``contextnet.py:137``): per VGG block two
    reflect "same" ``Conv2d``s with ReLU (``conv{i}a``, ``conv{i}b``) and a
    2x2 max pool, the (frequency, channel) axes flattened, then the LSTM.
    ``rng`` (a ``StepRNG``) draws its inter-layer dropout in training.

    Example
    -------
    >>> import torch
    >>> vgg = ESPnetVGG(input_size=40, vgg_channels=(4, 8),
    ...                 rnn_neurons=16, rnn_layers=1)
    >>> vgg(torch.ones(2, 8, 40)).shape
    torch.Size([2, 2, 32])
    """

    def __init__(self, input_size, vgg_channels=(64, 128), rnn_neurons=512,
                 rnn_layers=4, rnn_bidirectional=True, dropout=0.15):
        super().__init__()
        self.n_vgg = len(vgg_channels)
        in_ch = 1
        for i, ch in enumerate(vgg_channels):
            self.add_module(f"conv{i}a", Conv2d(ch, 3, in_ch, padding="same",
                                                padding_mode="reflect"))
            self.add_module(f"conv{i}b", Conv2d(ch, 3, ch, padding="same",
                                                padding_mode="reflect"))
            in_ch = ch
        self.pool = Pooling2d("max", (2, 2))
        feat = input_size
        for _ in vgg_channels:
            feat = feat // 2
        self.rnn = LSTM(rnn_neurons, input_size=feat * in_ch,
                        num_layers=rnn_layers,
                        bidirectional=rnn_bidirectional, dropout=dropout)

    def forward(self, x, rng=None, train=False):
        h = x[..., None]
        for i in range(self.n_vgg):
            h = F.relu(getattr(self, f"conv{i}a")(h))
            h = self.pool(F.relu(getattr(self, f"conv{i}b")(h)))
        h = h.reshape(h.shape[0], h.shape[1], -1)
        return self.rnn(h, rng=rng, train=train)[0]

"""X-vector speaker embeddings and the embedding discriminator (port of
``svt_speechbrain_tpu/models/xvector.py``). The TDNN blocks' BatchNorm
statistics are buffers; the JAX state tree keeps each at its block's path
(``tdnn{i}``), the block naming its norm child (``jax_state_child``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (BatchNorm1d,
                                                          LayerNorm)
from svt_speechbrain_tpu_torch.nnet.pooling import StatisticsPooling


class XvectorBlock(nn.Module):
    """One TDNN block of ``Xvector``: a reflect-padded "same" ``conv``; its
    ``norm`` runs after the activation (children named as the JAX tree's
    ``tdnn{i}``)."""

    jax_state_child = "norm"

    def __init__(self, out_channels, kernel_size, in_channels, dilation):
        super().__init__()
        self.conv = Conv1d(out_channels, kernel_size, in_channels,
                           dilation=dilation, padding="same",
                           padding_mode="reflect")
        self.norm = BatchNorm1d(out_channels)


class Xvector(nn.Module):
    """TDNN blocks (Conv1d → activation → BatchNorm1d) → statistics pooling
    (over each row's valid frames with relative ``lengths``) → ``Linear``
    (``xvector.py:15``): (B, T, F) → (B, 1, lin_neurons).

    Example
    -------
    >>> import torch
    >>> model = Xvector(in_channels=24, lin_neurons=64,
    ...                 tdnn_channels=(32, 32, 32, 32, 96))
    >>> model(torch.ones(2, 50, 24)).shape
    torch.Size([2, 1, 64])
    """

    def __init__(self, in_channels=40, activation="leaky_relu",
                 tdnn_blocks=5, tdnn_channels=(512, 512, 512, 512, 1500),
                 tdnn_kernel_sizes=(5, 3, 3, 1, 1),
                 tdnn_dilations=(1, 2, 3, 1, 1), lin_neurons=512):
        super().__init__()
        self.tdnn_blocks = tdnn_blocks
        in_ch = in_channels
        for i in range(tdnn_blocks):
            self.add_module(f"tdnn{i}", XvectorBlock(
                tdnn_channels[i], tdnn_kernel_sizes[i], in_ch,
                tdnn_dilations[i]))
            in_ch = tdnn_channels[i]
        self.pool = StatisticsPooling()
        self.fc = Linear(lin_neurons, in_ch * 2)
        self.activation = activation

    def forward(self, x, lengths=None, train=False):
        act = F.leaky_relu if self.activation == "leaky_relu" else torch.relu
        for i in range(self.tdnn_blocks):
            block = getattr(self, f"tdnn{i}")
            x = block.norm(act(block.conv(x)), train=train)
        return self.fc(self.pool(x, lengths=lengths))[:, None, :]


class Discriminator(nn.Module):
    """MLP over x-vector embeddings (``xvector.py:82``): ``lin_blocks`` x
    (``Linear`` → ``LayerNorm`` → leaky ReLU), children ``block{i}`` with
    ``linear`` and ``norm``, then ``out`` to one logit."""

    def __init__(self, input_size=512, lin_blocks=2, lin_neurons=512):
        super().__init__()
        self.lin_blocks = lin_blocks
        in_size = input_size
        for i in range(lin_blocks):
            block = nn.Module()
            block.linear = Linear(lin_neurons, in_size)
            block.norm = LayerNorm(lin_neurons)
            self.add_module(f"block{i}", block)
            in_size = lin_neurons
        self.out = Linear(1, in_size)

    def forward(self, x):
        for i in range(self.lin_blocks):
            block = getattr(self, f"block{i}")
            x = F.leaky_relu(block.norm(block.linear(x)))
        return self.out(x)

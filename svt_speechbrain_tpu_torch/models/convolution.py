"""Convolutional frontends for transformer ASR (port of
``svt_speechbrain_tpu/models/convolution.py``)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import Conv2d
from svt_speechbrain_tpu_torch.nnet.normalization import LayerNorm


class ConvolutionFrontEnd(nn.Module):
    """Strided conv blocks that downsample time (and frequency) before a
    transformer encoder (``convolution.py:13``). (B, T, F) in; each block is
    ``num_layers_per_block`` reflect-padded "same" ``Conv2d``s (the last
    one strided on both axes), a ``LayerNorm`` over the channels and the
    exact GELU; out (B, T', F'·C), the JAX module's (frequency, channel)
    flattening. The children are named as the JAX tree's keys: ``b{i}l{j}``
    and ``norm{i}``.

    Example
    -------
    >>> import torch
    >>> fe = ConvolutionFrontEnd(input_size=40, out_channels=(8, 16, 32),
    ...                          strides=(2, 2, 1))
    >>> fe(torch.ones(2, 16, 40)).shape, fe.output_dim()
    (torch.Size([2, 4, 320]), 320)
    """

    def __init__(self, input_shape=None, input_size=None, num_blocks=3,
                 num_layers_per_block=1, out_channels=(128, 256, 512),
                 kernel_sizes=(3, 3, 3), strides=(2, 2, 1), residuals=None):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = input_shape[-1]
        self.num_blocks = num_blocks
        self.num_layers_per_block = num_layers_per_block
        in_ch = 1
        for b in range(num_blocks):
            for l in range(num_layers_per_block):
                stride = strides[b] if l == num_layers_per_block - 1 else 1
                self.add_module(f"b{b}l{l}", Conv2d(
                    out_channels[b], kernel_sizes[b], in_ch,
                    stride=(stride, stride), padding="same",
                    padding_mode="reflect"))
                in_ch = out_channels[b]
            self.add_module(f"norm{b}", LayerNorm(out_channels[b]))
        self.input_size = input_size
        self.out_channels = out_channels
        self.strides = strides

    def output_dim(self):
        f = self.input_size
        for s in self.strides:
            f = -(-f // s)
        return f * self.out_channels[-1]

    def forward(self, x):
        h = x[..., None]                                   # (B, T, F, 1)
        for b in range(self.num_blocks):
            for l in range(self.num_layers_per_block):
                h = getattr(self, f"b{b}l{l}")(h)
            h = F.gelu(getattr(self, f"norm{b}")(h))
        return h.reshape(h.shape[0], h.shape[1], -1)

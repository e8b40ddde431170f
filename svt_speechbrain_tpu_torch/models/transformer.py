"""Transformer pieces that the fusion network uses (port of
``svt_speechbrain_tpu/models/transformer.py:23-56``): the sinusoidal
``PositionalEncoding`` and the two mask helpers. The encoder and decoder
stacks of the JAX module are ROADMAP.md queue 1 item 19."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class PositionalEncoding(nn.Module):
    """Sinusoidal absolute positional encoding (``transformer.py:23``):
    ``module(x)`` returns the (1, T, d) table of ``x``'s length, in ``x``'s
    dtype, to add to ``x``. The table is built in numpy, as in the JAX
    package, so both hold the same numbers; it is a buffer, not a
    parameter, and is left out of the state dict.

    Example
    -------
    >>> pe = PositionalEncoding(input_size=8, max_len=100)
    >>> pe(torch.zeros(2, 5, 8)).shape
    torch.Size([1, 5, 8])
    """

    def __init__(self, input_size, max_len=2500):
        super().__init__()
        self.input_size = input_size
        self.max_len = max_len
        pe = np.zeros((max_len, input_size), np.float32)
        positions = np.arange(max_len, dtype=np.float32)[:, None]
        denominator = np.exp(-np.arange(0, input_size, 2, dtype=np.float32)
                             * np.log(10000.0) / input_size)
        pe[:, 0::2] = np.sin(positions * denominator)
        pe[:, 1::2] = np.cos(positions * denominator)
        self.register_buffer("pe", torch.from_numpy(pe[None]),
                             persistent=False)

    def forward(self, x):
        return self.pe[:, :x.shape[1]].to(x.dtype)


def get_lookahead_mask(padded_input):
    """Causal mask (T, T): True above the diagonal = masked
    (``transformer.py:45``)."""
    t = padded_input.shape[1]
    return torch.triu(torch.ones(t, t, dtype=torch.bool,
                                 device=padded_input.device), diagonal=1)


def get_key_padding_mask(padded_input, pad_idx):
    """Key padding mask (B, T) of a padded token tensor: True where the
    first feature equals ``pad_idx`` (``transformer.py:52``)."""
    if padded_input.dim() == 3:
        padded_input = padded_input[..., 0]
    return padded_input == pad_idx

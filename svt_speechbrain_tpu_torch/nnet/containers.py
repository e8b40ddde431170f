"""Containers (port of ``svt_speechbrain_tpu/nnet/containers.py``). The
children are named "0", "1", ..., as the JAX trees key their layers."""
from __future__ import annotations

import inspect

from torch import nn


class Sequential(nn.Sequential):
    """Apply the layers in order (``containers.py:7``), with the keyword
    arguments of the call handed to every layer.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> seq = Sequential(Linear(8, 4), Linear(2, 8))
    >>> [name for name, _ in seq.named_children()]
    ['0', '1']
    >>> seq(torch.ones(5, 4)).shape
    torch.Size([5, 2])
    """

    def __init__(self, *layers):
        super().__init__(*layers)

    def forward(self, x, **kwargs):
        for layer in self:
            x = layer(x, **kwargs)
        return x


class LengthsCapableSequential(Sequential):
    """``Sequential`` that hands ``lengths`` to the layers whose forward
    takes it, and keeps the first item of a layer's tuple output
    (``containers.py:38``)."""

    def forward(self, x, lengths=None, **kwargs):
        for layer in self:
            try:
                takes = "lengths" in inspect.signature(
                    layer.forward).parameters
            except (TypeError, ValueError):
                takes = False
            if takes and lengths is not None:
                x = layer(x, lengths=lengths, **kwargs)
            else:
                x = layer(x, **kwargs)
            if isinstance(x, tuple):
                x = x[0]
        return x


class ConnectBlocks(nn.Module):
    """Blocks in a chain with shortcuts (``containers.py:60``):
    "residual" adds the running shortcut to each output of its shape (and
    the sum becomes the shortcut), "dense" adds each block's input to an
    output of its shape, "skip" sums the outputs of the first one's shape.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> blocks = ConnectBlocks(Linear(4, 4), Linear(4, 4))
    >>> blocks(torch.ones(2, 4)).shape
    torch.Size([2, 4])
    """

    def __init__(self, *blocks, shortcut_type="residual",
                 shortcut_projection=False):
        super().__init__()
        if shortcut_type not in ("residual", "dense", "skip"):
            raise ValueError(f"unknown shortcut_type {shortcut_type!r}")
        for i, block in enumerate(blocks):
            self.add_module(str(i), block)
        self.shortcut_type = shortcut_type

    def forward(self, x, **kwargs):
        shortcut = x
        skips = []
        for block in self.children():
            y = block(x, **kwargs)
            if isinstance(y, tuple):
                y = y[0]
            if self.shortcut_type == "residual" and y.shape == shortcut.shape:
                y = y + shortcut
                shortcut = y
            elif self.shortcut_type == "dense" and y.shape == x.shape:
                y = y + x
            elif self.shortcut_type == "skip":
                skips.append(y)
            x = y
        if self.shortcut_type == "skip":
            out = skips[0]
            for s in skips[1:]:
                if s.shape == out.shape:
                    out = out + s
            return out
        return x


class ModuleList(nn.ModuleList):
    """A list of modules whose use is the caller's (``containers.py:97``),
    built from positional modules as the JAX class is.

    Example
    -------
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> ml = ModuleList(Linear(2, 3), Linear(3, 2))
    >>> len(ml), type(ml[1]).__name__
    (2, 'Linear')
    """

    def __init__(self, *modules):
        super().__init__(modules)

"""Convolutions (port of ``svt_speechbrain_tpu/nnet/cnn.py``).

Channel-last at the boundary: ``Conv1d`` takes and returns (batch, time,
channels), ``Conv2d`` (batch, H, W, C), ``Conv3d`` (batch, T, H, W, C). The
weight is kept in torch's (out, in/groups, *k) layout; the JAX layout
(*k, in/groups, out) is converted when weights are loaded
(``convert_jax.py``). The products run in ``F.conv1d``/``conv2d``/
``conv3d``: the JAX package runs these convolutions in XLA, outside any
Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv_output_length(length, kernel, stride):
    """Output length of a "valid" conv along one axis (``cnn.py:27``)."""
    return (length - kernel) // stride + 1


def jax_to_torch_conv_weight(w):
    """(*k, in/groups, out) → (out, in/groups, *k)."""
    n = w.dim()
    return w.permute(n - 1, n - 2, *range(n - 2)).contiguous()


def torch_to_jax_conv_weight(w):
    """(out, in/groups, *k) → (*k, in/groups, out)."""
    return w.permute(*range(2, w.dim()), 1, 0).contiguous()


class Conv1d(nn.Module):
    """1-D conv over (batch, time, channels) with "valid" padding
    (``cnn.py:145``/``_ConvNd`` ``:43``), optional groups and bias.

    Example
    -------
    >>> import torch
    >>> conv = Conv1d(out_channels=8, kernel_size=3, in_channels=4, stride=2)
    >>> conv(torch.ones(2, 16, 4)).shape
    torch.Size([2, 7, 8])
    """

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 groups=1, bias=True):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("in/out channels must be divisible by groups")
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(
            out_channels, in_channels // groups, kernel_size))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype),
                     stride=self.stride, groups=self.groups).transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def _ntuple(x, n):
    if isinstance(x, (tuple, list)):
        if len(x) != n:
            raise ValueError(f"expected {n} values, got {tuple(x)}")
        return tuple(x)
    return (x,) * n


class _ConvNd(nn.Module):
    """N-dimensional conv over channel-last input (``cnn.py:43``): (batch,
    *spatial, channels) in and out. The weight is kept in torch's layout
    (out, in/groups, *k); ``convert_jax`` turns the JAX (*k, in/groups,
    out) into it.

    Padding "same" follows the JAX rule (``cnn.py:99-117``): an axis with
    stride above 1 pads ``k // 2`` on each side (dilation ignored), a
    stride-1 axis pads ``(d·(k-1)) // 2``; "valid" pads nothing. The
    product runs in ``F.conv2d``/``F.conv3d`` (cuDNN on the card) on a
    channel-first view of the channel-last tensor, which cuDNN reads as
    its channels-last layout without a copy."""

    NDIM = 2

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 dilation=1, padding="same", groups=1, bias=True):
        super().__init__()
        n = self.NDIM
        if in_channels % groups or out_channels % groups:
            raise ValueError("in/out channels must be divisible by groups")
        if padding not in ("same", "valid"):
            raise ValueError(f"unknown padding {padding!r}")
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = _ntuple(stride, n)
        self.dilation = _ntuple(dilation, n)
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(
            out_channels, in_channels // groups, *self.kernel_size))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def pads(self):
        """Symmetric padding of each spatial axis."""
        if self.padding == "valid":
            return (0,) * self.NDIM
        return tuple(k // 2 if s > 1 else (d * (k - 1)) // 2 for k, s, d in
                     zip(self.kernel_size, self.stride, self.dilation))

    def forward(self, x):
        conv = F.conv2d if self.NDIM == 2 else F.conv3d
        last = x.dim() - 1
        y = conv(x.movedim(last, 1), self.weight.to(x.dtype), stride=self.stride,
                 padding=self.pads(), dilation=self.dilation,
                 groups=self.groups).movedim(1, last)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Conv2d(_ConvNd):
    """2-D conv over (batch, H, W, C) (``cnn.py:164``).

    Example
    -------
    >>> import torch
    >>> conv = Conv2d(out_channels=6, kernel_size=3, in_channels=2, stride=2)
    >>> conv(torch.ones(1, 10, 12, 2)).shape
    torch.Size([1, 5, 6, 6])
    """

    NDIM = 2


class Conv3d(_ConvNd):
    """3-D conv over (batch, T, H, W, C): the lip-ROI frontend's conv
    (``cnn.py:179``).

    Example
    -------
    >>> import torch
    >>> conv = Conv3d(64, (5, 7, 7), 1, stride=(1, 2, 2), bias=False)
    >>> conv.pads(), conv(torch.ones(1, 3, 16, 16, 1)).shape
    ((2, 3, 3), torch.Size([1, 3, 8, 8, 64]))
    """

    NDIM = 3

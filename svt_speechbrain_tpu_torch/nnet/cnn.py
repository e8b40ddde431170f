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

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_PAD_MODES = ("zeros", "reflect", "replicate", "circular")


def conv_output_length(length, kernel, stride, padding="valid", dilation=1):
    """Output length of a conv along one axis (``cnn.py:27``), with the
    "same" rule of ``_ConvNd`` (even kernels shrink by one at stride 1)."""
    eff_k = dilation * (kernel - 1) + 1
    if padding == "same":
        pad = kernel // 2 if stride > 1 else (dilation * (kernel - 1)) // 2
        return (length + 2 * pad - eff_k) // stride + 1
    if padding == "causal":
        length = length + eff_k - 1
    return (length - eff_k) // stride + 1


def jax_to_torch_conv_weight(w):
    """(*k, in/groups, out) → (out, in/groups, *k)."""
    n = w.dim()
    return w.permute(n - 1, n - 2, *range(n - 2)).contiguous()


def torch_to_jax_conv_weight(w):
    """(out, in/groups, *k) → (*k, in/groups, out)."""
    return w.permute(*range(2, w.dim()), 1, 0).contiguous()


def _ntuple(x, n):
    if isinstance(x, (tuple, list)):
        if len(x) != n:
            raise ValueError(f"expected {n} values, got {tuple(x)}")
        return tuple(x)
    return (x,) * n


def pad_config(padding, kernel_size, stride, dilation):
    """(before, after) padding of each axis for ``padding`` "same",
    "causal" or "valid" (``cnn.py:89-111``)."""
    if padding == "valid":
        return [(0, 0)] * len(kernel_size)
    pads = []
    for k, s, d in zip(kernel_size, stride, dilation):
        eff_k = d * (k - 1) + 1
        if padding == "causal":
            pads.append((eff_k - 1, 0))
        else:
            pad = k // 2 if s > 1 else (eff_k - 1) // 2
            pads.append((pad, pad))
    return pads


def conv_nd(x, weight, ndim, pads, padding_mode="zeros", **kwargs):
    """``F.conv{ndim}d`` of a channel-last ``x`` padded by ``pads`` in
    ``padding_mode``, through a channel-first view (cuDNN reads it as its
    channels-last layout without a copy)."""
    conv = (F.conv1d, F.conv2d, F.conv3d)[ndim - 1]
    last = x.dim() - 1
    x = x.movedim(last, 1)
    padding = tuple(lo for lo, _ in pads)
    if padding_mode != "zeros" or any(lo != hi for lo, hi in pads):
        if any(p != (0, 0) for p in pads):
            flat = [v for lo_hi in reversed(pads) for v in lo_hi]
            x = F.pad(x, flat, mode="constant" if padding_mode == "zeros"
                      else padding_mode)
        padding = 0
    return conv(x, weight.to(x.dtype), padding=padding,
                **kwargs).movedim(1, last)


class _ConvNd(nn.Module):
    """N-dimensional conv over channel-last input (``cnn.py:43``): (batch,
    *spatial, channels) in and out. The weight is kept in torch's layout
    (out, in/groups, *k); ``convert_jax`` turns the JAX (*k, in/groups,
    out) into it.

    ``padding`` (``cnn.py:89-111``): "same" pads an axis with stride above
    1 by ``k // 2`` on each side (dilation ignored) and a stride-1 axis by
    ``(d·(k-1)) // 2`` (an even kernel shrinks the axis by one); "causal"
    pads ``d·(k-1)`` before; "valid" pads nothing. ``padding_mode``
    "zeros", "reflect", "replicate" or "circular" fills the pad
    (``cnn.py:119-125``). The product runs in ``F.conv1d``/``conv2d``/
    ``conv3d`` (cuDNN on the card)."""

    NDIM = 2

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 dilation=1, padding="same", groups=1, bias=True,
                 padding_mode="zeros"):
        super().__init__()
        n = self.NDIM
        if in_channels % groups or out_channels % groups:
            raise ValueError("in/out channels must be divisible by groups")
        if padding not in ("same", "valid", "causal"):
            raise ValueError(f"unknown padding {padding!r}")
        if padding_mode not in _PAD_MODES:
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = _ntuple(stride, n)
        self.dilation = _ntuple(dilation, n)
        self.padding = padding
        self.groups = groups
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.zeros(
            out_channels, in_channels // groups, *self.kernel_size))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def _pad_config(self):
        """(before, after) padding of each spatial axis."""
        return pad_config(self.padding, self.kernel_size, self.stride,
                          self.dilation)

    def pads(self):
        """Symmetric padding of each spatial axis ("same" and "valid")."""
        return tuple(lo for lo, _ in self._pad_config())

    def _weight(self):
        return self.weight

    def forward(self, x):
        y = conv_nd(x, self._weight(), self.NDIM, self._pad_config(),
                    self.padding_mode, stride=self.stride,
                    dilation=self.dilation, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Conv1d(_ConvNd):
    """1-D conv over (batch, time, channels) (``cnn.py:145``).

    Example
    -------
    >>> import torch
    >>> conv = Conv1d(out_channels=8, kernel_size=3, in_channels=4)
    >>> conv(torch.ones(2, 16, 4)).shape                  # "same" padding
    torch.Size([2, 16, 8])
    >>> Conv1d(8, 3, 4, stride=2, padding="valid")(torch.ones(2, 16, 4)).shape
    torch.Size([2, 7, 8])
    """

    NDIM = 1


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


class ConvTranspose1d(nn.Module):
    """Transposed 1-D conv over (batch, time, channels) (``cnn.py:186``),
    torch's ``ConvTranspose1d`` semantics: ``weight`` is kept (in, out, k)
    as torch keeps it; the JAX layout is (k, out, in).

    Example
    -------
    >>> import torch
    >>> ConvTranspose1d(4, 3, 2, stride=2)(torch.ones(1, 5, 2)).shape
    torch.Size([1, 11, 4])
    """

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 padding=0, output_padding=0, bias=True):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.in_channels = in_channels
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels,
                                               kernel_size))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def forward(self, x):
        y = F.conv_transpose1d(
            x.transpose(1, 2), self.weight.to(x.dtype), stride=self.stride,
            padding=self.padding, output_padding=self.output_padding)
        y = y.transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class DepthwiseSeparableConv1d(nn.Module):
    """Depthwise (one group a channel) + pointwise 1-D conv
    (``cnn.py:226``).

    Example
    -------
    >>> import torch
    >>> DepthwiseSeparableConv1d(8, 3, 4)(torch.ones(2, 10, 4)).shape
    torch.Size([2, 10, 8])
    """

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 dilation=1, padding="same", bias=True):
        super().__init__()
        self.depthwise = Conv1d(in_channels, kernel_size, in_channels,
                                stride=stride, dilation=dilation,
                                padding=padding, groups=in_channels,
                                bias=bias)
        self.pointwise = Conv1d(out_channels, 1, in_channels,
                                padding="valid", bias=bias)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class DepthwiseSeparableConv2d(nn.Module):
    """Depthwise (one group a channel) + pointwise 1x1 2-D conv
    (``cnn.py:346``)."""

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 dilation=1, padding="same", bias=True):
        super().__init__()
        self.depthwise = Conv2d(in_channels, kernel_size, in_channels,
                                stride=stride, dilation=dilation,
                                padding=padding, groups=in_channels,
                                bias=bias)
        self.pointwise = Conv2d(out_channels, 1, in_channels, bias=bias)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SincConv(nn.Module):
    """SincNet's band-pass filterbank conv (``cnn.py:244``): learned
    ``low_hz`` and ``band_hz`` (out, 1), mel-spaced at construction (the
    JAX ``init``, which draws nothing); the (out, k) kernel is built on
    each call and run as a bias-free ``Conv1d``. An even kernel size is
    made odd.

    Example
    -------
    >>> import torch
    >>> SincConv(8, 31)(torch.ones(2, 100, 1)).shape
    torch.Size([2, 100, 8])
    """

    def __init__(self, out_channels, kernel_size, in_channels=1, stride=1,
                 dilation=1, padding="same", sample_rate=16000,
                 min_low_hz=50, min_band_hz=50):
        super().__init__()
        if kernel_size % 2 == 0:
            kernel_size = kernel_size + 1
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.in_channels = in_channels
        self.stride = stride
        self.dilation = dilation
        self.padding = padding
        self.sample_rate = sample_rate
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        low_hz, band_hz = self.mel_init()
        self.low_hz = nn.Parameter(torch.from_numpy(low_hz))
        self.band_hz = nn.Parameter(torch.from_numpy(band_hz))

    def mel_init(self):
        """The mel-spaced (low_hz, band_hz) of ``cnn.py:264-281``."""
        low = 30.0
        high = self.sample_rate / 2 - (self.min_low_hz + self.min_band_hz)
        mel = np.linspace(2595 * np.log10(1 + low / 700),
                          2595 * np.log10(1 + high / 700),
                          self.out_channels + 1)
        hz = 700 * (10 ** (mel / 2595) - 1)
        return (hz[:-1, None].astype(np.float32),
                np.diff(hz)[:, None].astype(np.float32))

    def filters(self):
        """The (out, k) band-pass kernel (``cnn.py:283``)."""
        low = self.min_low_hz + self.low_hz.abs()
        high = torch.clamp(low + self.min_band_hz + self.band_hz.abs(),
                           self.min_low_hz, self.sample_rate / 2)
        band = (high - low)[:, 0]
        n_ = (self.kernel_size - 1) / 2.0
        dev = low.device
        n = (torch.arange(-n_, 0.0, device=dev)[None, :] * 2 * math.pi
             / self.sample_rate)
        window = 0.54 - 0.46 * torch.cos(
            2 * math.pi * torch.arange(0, n_, device=dev) / self.kernel_size)
        f_low, f_high = low @ n, high @ n
        bp_left = ((torch.sin(f_high) - torch.sin(f_low)) / (n / 2)) * window
        bp_center = 2 * band[:, None]
        filters = torch.cat([bp_left, bp_center, bp_left.flip(-1)], dim=1)
        return filters / (2 * band[:, None])

    def forward(self, x):
        pads = pad_config(self.padding, (self.kernel_size,), (self.stride,),
                          (self.dilation,))
        return conv_nd(x, self.filters()[:, None, :], 1, pads,
                       stride=self.stride, dilation=self.dilation)


def get_padding_elem(L_in, stride, kernel_size, dilation):
    """Per-side "same" padding (``cnn.py:308``).

    Example
    -------
    >>> get_padding_elem(16, 1, 5, 1), get_padding_elem(16, 2, 4, 1)
    ([2, 2], [2, 2])
    """
    if stride > 1:
        return [math.floor(kernel_size / 2), math.floor(kernel_size / 2)]
    L_out = math.floor((L_in - dilation * (kernel_size - 1) - 1) / stride) + 1
    return [math.floor((L_in - L_out) / 2), math.floor((L_in - L_out) / 2)]


def get_padding_elem_transposed(L_out, L_in, stride, kernel_size, dilation,
                                output_padding):
    """Padding of a transposed conv for an exact output length
    (``cnn.py:319``).

    Example
    -------
    >>> get_padding_elem_transposed(32, 16, 2, 4, 1, 0)
    1
    """
    padding = -0.5 * (L_out - (L_in - 1) * stride - dilation
                      * (kernel_size - 1) - output_padding - 1)
    return int(padding)


class Conv2dWithConstraint(Conv2d):
    """``Conv2d`` with a max-norm constraint on each output filter, applied
    at call time (``cnn.py:328``): the filter is scaled by min(1, max_norm
    / max(‖filter‖, 1e-12))."""

    def __init__(self, *args, max_norm=1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_norm = max_norm

    def _weight(self):
        w = self.weight
        norm = w.square().sum(dim=tuple(range(1, w.dim())),
                              keepdim=True).sqrt()
        return w * torch.clamp(self.max_norm / torch.clamp(norm, min=1e-12),
                               max=1.0)

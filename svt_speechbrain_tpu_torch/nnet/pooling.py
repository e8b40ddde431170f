"""Pooling (port of ``svt_speechbrain_tpu/nnet/pooling.py``). Channel-last:
(batch, time, channels) for 1-D pooling, (batch, H, W, channels) for 2-D.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def _reduce_window(x, window, stride, padding, mode):
    """Max or average pooling over the ``len(window)`` axes after the batch
    axis of a channel-last tensor (``pooling.py:10-21``): ``padding`` pairs
    pad with -inf (max) or 0 (average), the windows are those that fit (no
    ceil mode), and an average divides by the full window size."""
    n = len(window)
    last = x.dim() - 1
    x = x.movedim(last, 1)
    flat = [v for pair in reversed(padding) for v in pair]
    if any(flat):
        x = F.pad(x, flat, value=-math.inf if mode == "max" else 0.0)
    fn = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
          ("avg", 1): F.avg_pool1d, ("avg", 2): F.avg_pool2d}[(mode, n)]
    return fn(x, tuple(window), tuple(stride)).movedim(1, last)


class Pooling1d(nn.Module):
    """1-D max or average pooling over (batch, time, channels)
    (``pooling.py:23``). ``ceil_mode`` is accepted and, as in the JAX
    module, not applied: the windows are those that fit.

    Example
    -------
    >>> import torch
    >>> pool = Pooling1d("max", kernel_size=2)
    >>> pool(torch.tensor([[[1.0], [4.0], [2.0], [3.0]]]))[0, :, 0].tolist()
    [4.0, 3.0]
    """

    def __init__(self, pool_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False):
        super().__init__()
        self.pool_type = pool_type
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return _reduce_window(
            x, (self.kernel_size,), (self.stride,),
            ((self.padding, self.padding),),
            "max" if self.pool_type == "max" else "avg")


class Pooling2d(nn.Module):
    """2-D max or average pooling over (batch, H, W, channels)
    (``pooling.py:51``).

    Example
    -------
    >>> import torch
    >>> Pooling2d("max", (1, 2))(torch.ones(2, 5, 40, 3)).shape
    torch.Size([2, 5, 20, 3])
    """

    def __init__(self, pool_type, kernel_size, stride=None, padding=0):
        super().__init__()
        self.pool_type = pool_type
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride or self.kernel_size)
        self.padding = _pair(padding)

    def forward(self, x):
        return _reduce_window(
            x, self.kernel_size, self.stride,
            tuple((p, p) for p in self.padding),
            "max" if self.pool_type == "max" else "avg")


class StatisticsPooling(nn.Module):
    """Mean and standard deviation over time (``pooling.py:72``), for
    (batch, time, channels) → (batch, 2·channels) (or one of the two).
    Without ``lengths``: the plain mean and the unbiased std. With relative
    ``lengths``: over each row's first round(length · T) frames (at least
    1), std = sqrt(var + eps) with var divided by max(n − 1, 1).

    Example
    -------
    >>> import torch
    >>> out = StatisticsPooling()(torch.tensor([[[1.0], [3.0]]]))
    >>> [round(v, 3) for v in out[0].tolist()]
    [2.0, 1.414]
    """

    def __init__(self, return_mean=True, return_std=True, eps=1e-5):
        super().__init__()
        self.return_mean = return_mean
        self.return_std = return_std
        self.eps = eps

    def forward(self, x, lengths=None):
        if lengths is None:
            mean = x.mean(dim=1)
            std = x.std(dim=1, unbiased=True)
        else:
            t = x.shape[1]
            lengths = torch.as_tensor(lengths, device=x.device)
            n = torch.clamp(torch.round(lengths * t), 1, t)[:, None]
            mask = (torch.arange(t, device=x.device)[None, :, None]
                    < n[..., None]).to(x.dtype)
            mean = (x * mask).sum(dim=1) / n
            var = (((x - mean[:, None]).square() * mask).sum(dim=1)
                   / torch.clamp(n - 1, min=1))
            std = torch.sqrt(var + self.eps)
        outs = ([mean] if self.return_mean else []) + (
            [std] if self.return_std else [])
        return torch.cat(outs, dim=-1)


class AdaptiveAvgPool2d(nn.Module):
    """Global average pooling of (batch, H, W, C) to (batch, 1, 1, C), the
    only output size the JAX module supports (``pooling.py:113``); any
    other raises ``NotImplementedError``.

    Example
    -------
    >>> import torch
    >>> AdaptiveAvgPool2d()(torch.ones(2, 4, 4, 3)).shape
    torch.Size([2, 1, 1, 3])
    """

    def __init__(self, output_size=(1, 1)):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        if self.output_size != (1, 1):
            raise NotImplementedError("only global (1,1) pooling is "
                                      "supported")
        return x.mean(dim=(1, 2), keepdim=True)


class AdaptivePool(nn.Module):
    """Adaptive average pooling to ``output_size`` (``pooling.py:128``): an
    int pools the time axis (axis 1), a pair pools axes 1 and 2; bucket
    ``i`` of ``out`` over ``n`` averages positions
    [floor(i·n/out), ceil((i+1)·n/out)), torch's ``AdaptiveAvgPool``
    bucketing.

    Example
    -------
    >>> import torch
    >>> x = torch.arange(5.0)[None, :, None]
    >>> AdaptivePool(2)(x)[0, :, 0].tolist()
    [1.0, 3.0]
    """

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    @staticmethod
    def _pool_axis(x, out, axis):
        moved = x.movedim(axis, -1)
        shape = moved.shape
        y = F.adaptive_avg_pool1d(moved.reshape(-1, 1, shape[-1]), out)
        return y.reshape(*shape[:-1], out).movedim(-1, axis)

    def forward(self, x):
        size = self.output_size
        if isinstance(size, int):
            return self._pool_axis(x, size, 1)
        return self._pool_axis(self._pool_axis(x, size[0], 1), size[1], 2)

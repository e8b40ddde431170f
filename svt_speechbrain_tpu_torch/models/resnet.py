"""Visual frontend: Conv3d + per-frame ResNet-18 over lip-ROI video (port of
``svt_speechbrain_tpu/models/resnet.py``).

- ``frontend3D``: Conv3d(1→64, k (5, 7, 7), s (1, 2, 2), pad (2, 3, 3), no
  bias) + BatchNorm3d + PReLU + MaxPool3d(k (1, 3, 3), s (1, 2, 2), pad
  (0, 1, 1), -inf padding): time kept, space /4;
- a per-frame ResNet-18 trunk (``BasicBlock`` [2, 2, 2, 2] at 64/128/256/
  512, PReLU or ReLU, 1×1-conv + BN downsampling) with time folded into the
  batch, and a global average pool to 512 per frame.

Channel-last throughout, video (B, T, H, W, 1) in and (B, T, 512) out. The
convolutions run in cuDNN on the card (``nnet/cnn.py``); the BatchNorm
running statistics are buffers of the modules (``nnet/normalization.py``),
updated in place by a training forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.activations import PReLU
from svt_speechbrain_tpu_torch.nnet.cnn import Conv2d, Conv3d
from svt_speechbrain_tpu_torch.nnet.normalization import (BatchNorm2d,
                                                          BatchNorm3d)


class BasicBlock(nn.Module):
    """ResNet basic block with PReLU (``resnet.py:41``): conv3x3-BN-act,
    conv3x3-BN, the (downsampled) shortcut added, act."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 relu_type="prelu"):
        super().__init__()
        self.has_downsample = has_downsample
        self.relu_type = relu_type
        self.conv1 = conv3x3(planes, inplanes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes)
        if relu_type == "prelu":
            self.relu1 = PReLU(planes)
            self.relu2 = PReLU(planes)
        if has_downsample:
            self.down_conv, self.down_bn = downsample_basic_block(
                planes, inplanes, stride)

    def _act(self, name, x):
        if self.relu_type == "prelu":
            return getattr(self, name)(x)
        return F.relu(x)

    def forward(self, x, train=False):
        out = self._act("relu1", self.bn1(self.conv1(x), train=train))
        out = self.bn2(self.conv2(out), train=train)
        residual = x
        if self.has_downsample:
            residual = self.down_bn(self.down_conv(x), train=train)
        return self._act("relu2", out + residual)


class ResNetTrunk(nn.Module):
    """ResNet-18 trunk without stem (``resnet.py:108``): blocks
    ``layer{stage}_{block}`` at 64/128/256/512, then a global average pool.
    (N, H, W, 64) → (N, 512)."""

    def __init__(self, layers=(2, 2, 2, 2), relu_type="prelu"):
        super().__init__()
        self.block_names = []
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                block = BasicBlock(
                    inplanes, planes, stride if b == 0 else 1,
                    has_downsample=b == 0 and (stride != 1
                                               or inplanes != planes),
                    relu_type=relu_type)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block)
                self.block_names.append(name)
                inplanes = planes

    def forward(self, x, train=False):
        for name in self.block_names:
            x = getattr(self, name)(x, train=train)
        return x.mean(dim=(1, 2))


class ResEncoder(nn.Module):
    """Conv3d frontend + per-frame ResNet trunk (``resnet.py:154``):
    (B, T, H, W, 1) grayscale lip ROIs → (B, T, 512). ``train`` normalizes
    by the batch's statistics and updates the running ones.

    Example
    -------
    >>> import torch
    >>> enc = ResEncoder()
    >>> enc(torch.ones(1, 2, 32, 32, 1)).shape
    torch.Size([1, 2, 512])
    """

    def __init__(self, relu_type="prelu", weights=None):
        super().__init__()
        self.frontend_nout = 64
        self.backend_out = 512
        self.relu_type = relu_type
        self.frontend_conv = Conv3d(64, (5, 7, 7), 1, stride=(1, 2, 2),
                                    padding="same", bias=False)
        self.frontend_bn = BatchNorm3d(64)
        self.frontend_act = PReLU(64) if relu_type == "prelu" else None
        self.trunk = ResNetTrunk(relu_type=relu_type)
        self.weights = weights

    def forward(self, x, train=False):
        b, t = x.shape[0], x.shape[1]
        x = self.frontend_bn(self.frontend_conv(x), train=train)
        x = self.frontend_act(x) if self.frontend_act is not None else F.relu(x)
        # MaxPool3d k (1, 3, 3) s (1, 2, 2) pad (0, 1, 1): time folded into
        # the batch (the reference's ``threeD_to_2D``), padding -inf
        h, w, c = x.shape[2:]
        x = F.max_pool2d(x.reshape(b * t, h, w, c).movedim(3, 1), 3, 2, 1)
        x = self.trunk(x.movedim(1, 3), train=train)
        return x.reshape(b, t, self.backend_out)


def conv3x3(out_planes, in_planes, stride=1):
    """3×3 conv, no bias, channel-last (``resnet.py:219``)."""
    return Conv2d(out_planes, 3, in_planes, stride=stride, padding="same",
                  bias=False)


def downsample_basic_block(out_planes, in_planes, stride=1):
    """1×1-conv + BN downsample shortcut (``resnet.py:227``): (conv, bn)."""
    return (Conv2d(out_planes, 1, in_planes, stride=stride, padding="valid",
                   bias=False),
            BatchNorm2d(out_planes))


def downsample_basic_block_v2(out_planes, in_planes, stride=1):
    """AvgPool + 1×1-conv downsample variant (``resnet.py:238``):
    (pool_stride, conv, bn); the caller average-pools with ``pool_stride``
    first."""
    conv, bn = downsample_basic_block(out_planes, in_planes, stride=1)
    return stride, conv, bn


# the reference's public name: the torch lobe calls the trunk ``ResNet``
ResNet = ResNetTrunk

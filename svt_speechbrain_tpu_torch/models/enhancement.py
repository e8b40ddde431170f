"""Speech-enhancement models (port of
``svt_speechbrain_tpu/models/enhancement.py``): MetricGAN's generator and
discriminators, SEGAN's generator and discriminator, and their losses and
helpers. Channel-last; children named as the JAX trees."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d, Conv2d, ConvTranspose1d
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.rnn import LSTM


class EnhancementGenerator(nn.Module):
    """MetricGAN's generator (``enhancement.py:14``): a bidirectional LSTM
    → ``Linear`` to 300 → leaky ReLU (0.3) → ``Linear`` to the input width
    → sigmoid of the mask times one learnable scalar ``sigmoid_beta``.
    ``rng`` (a ``StepRNG``) draws the LSTM's inter-layer dropout in
    training.

    Example
    -------
    >>> import torch
    >>> g = EnhancementGenerator(input_size=8, hidden_size=6, num_layers=1)
    >>> mask = g(torch.ones(2, 5, 8))
    >>> mask.shape, bool(((mask >= 0) & (mask <= 1)).all())
    (torch.Size([2, 5, 8]), True)
    """

    def __init__(self, input_size=257, hidden_size=200, num_layers=2,
                 dropout=0.0):
        super().__init__()
        self.blstm = LSTM(hidden_size, input_size=input_size,
                          num_layers=num_layers, bidirectional=True,
                          dropout=dropout)
        self.linear1 = Linear(300, hidden_size * 2)
        self.linear2 = Linear(input_size, 300)
        self.sigmoid_beta = nn.Parameter(torch.ones(()))

    def forward(self, x, lengths=None, rng=None, train=False):
        h = self.blstm(x, rng=rng, train=train)[0]
        h = F.leaky_relu(self.linear1(h), 0.3)
        return torch.sigmoid(self.sigmoid_beta * self.linear2(h))


class MetricDiscriminator(nn.Module):
    """MetricGAN's discriminator (``enhancement.py:50``): four "valid"
    ``Conv2d``s with leaky ReLU (0.3) over (B, T, F, in_channels), the
    average over (T, F), three ``Linear``s → (B, 1)."""

    def __init__(self, in_channels=2, channels=15, kernel_size=5):
        super().__init__()
        self.n_convs = 4
        for i in range(self.n_convs):
            self.add_module(f"conv{i}", Conv2d(
                channels, kernel_size, in_channels if i == 0 else channels,
                padding="valid"))
        self.lin1 = Linear(50, channels)
        self.lin2 = Linear(10, 50)
        self.lin3 = Linear(1, 10)

    def forward(self, x):
        h = x
        for i in range(self.n_convs):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), 0.3)
        h = h.mean(dim=(1, 2))
        h = F.leaky_relu(self.lin1(h), 0.3)
        h = F.leaky_relu(self.lin2(h), 0.3)
        return self.lin3(h)


class SeganGenerator(nn.Module):
    """SEGAN's generator (``enhancement.py:81``): strided "same" ``Conv1d``s
    (``enc{i}``) with leaky ReLU (0.3), then ``ConvTranspose1d``s
    (``dec{i}``) over the previous output joined with the mirrored encoder
    output (both cut to the shorter), tanh at the end. (B, T) → (B, T')."""

    def __init__(self, kernel_size=32, channels=(16, 32, 64), latent_dim=64):
        super().__init__()
        in_ch = 1
        for i, ch in enumerate(channels):
            self.add_module(f"enc{i}", Conv1d(ch, kernel_size, in_ch,
                                              stride=2, padding="same"))
            in_ch = ch
        dec_channels = list(channels[-2::-1]) + [1]
        for i, ch in enumerate(dec_channels):
            self.add_module(f"dec{i}", ConvTranspose1d(
                ch, kernel_size, in_ch * 2 if i > 0 else in_ch, stride=2,
                padding=kernel_size // 2 - 1, output_padding=0))
            in_ch = ch
        self.n_enc, self.n_dec = len(channels), len(dec_channels)

    def forward(self, wav):
        h = wav[..., None]
        skips = []
        for i in range(self.n_enc):
            h = F.leaky_relu(getattr(self, f"enc{i}")(h), 0.3)
            skips.append(h)
        for i in range(self.n_dec):
            if i > 0:
                skip = skips[self.n_enc - 1 - i]
                t = min(h.shape[1], skip.shape[1])
                h = torch.cat([h[:, :t], skip[:, :t]], dim=-1)
            h = getattr(self, f"dec{i}")(h)
            if i < self.n_dec - 1:
                h = F.leaky_relu(h, 0.3)
        return torch.tanh(h[..., 0])


class SeganDiscriminator(nn.Module):
    """SEGAN's discriminator over (B, T, 2) waveform pairs
    (``enhancement.py:126``): strided "same" ``Conv1d``s with leaky ReLU
    (0.3), the mean over time, ``out`` → (B, 1)."""

    def __init__(self, kernel_size=32, channels=(16, 32, 64)):
        super().__init__()
        in_ch = 2
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv1d(ch, kernel_size, in_ch,
                                               stride=2, padding="same"))
            in_ch = ch
        self.n_convs = len(channels)
        self.out = Linear(1, in_ch)

    def forward(self, pair):
        h = pair
        for i in range(self.n_convs):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), 0.3)
        return self.out(h.mean(dim=1))


class MetricGAN_U_Discriminator(MetricDiscriminator):
    """MetricGAN-U's discriminator (``enhancement.py:151``): the same trunk
    over one (B, T, F) spectrogram."""

    def __init__(self, channels=15, kernel_size=5):
        super().__init__(in_channels=1, channels=channels,
                         kernel_size=kernel_size)

    def forward(self, spec):
        return super().forward(spec[..., None])


def shifted_sigmoid(x):
    """1.2 / (1 + exp(-x / 1.6)) (``enhancement.py:164``).

    Example
    -------
    >>> import torch
    >>> round(float(shifted_sigmoid(torch.zeros(1))), 6)
    0.6
    """
    return 1.2 / (1 + torch.exp(-(1 / 1.6) * x))


class Learnable_sigmoid(nn.Module):
    """1.2 · sigmoid(slope · x), one learnable ``slope`` per feature
    (``enhancement.py:169``)."""

    def __init__(self, in_features=257):
        super().__init__()
        self.in_features = in_features
        self.slope = nn.Parameter(torch.ones(in_features))

    def forward(self, x):
        return 1.2 * torch.sigmoid(self.slope * x)


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    return out.reshape(out.shape[0], -1).mean(dim=1)


def d1_loss(d_outputs, reduction="mean"):
    """SEGAN's discriminator loss on clean inputs, 0.5 (d - 1)²
    (``enhancement.py:184``)."""
    return _reduce(0.5 * (d_outputs - 1.0).square(), reduction)


def d2_loss(d_outputs, reduction="mean"):
    """SEGAN's discriminator loss on enhanced inputs, 0.5 d²
    (``enhancement.py:193``)."""
    return _reduce(0.5 * d_outputs.square(), reduction)


def g3_loss(d_outputs, predictions, targets, length=None, l1LossCoeff=100.0,
            klLossCoeff=0.0, z_mean=None, z_logvar=None, reduction="mean"):
    """SEGAN's generator loss (``enhancement.py:202``): 0.5 (d - 1)² +
    ``l1LossCoeff`` · |prediction - target| (+ ``klLossCoeff`` · the KL of
    a VAE latent when ``z_mean`` is given)."""
    discrimloss = 0.5 * (d_outputs - 1.0).square()
    l1norm = (predictions - targets).abs()
    if z_mean is not None:
        kl = 0.5 * (torch.exp(z_logvar) + z_mean.square() - 1.0 - z_logvar)
        kl = kl.sum(dim=tuple(range(1, kl.dim()))).mean()
    else:
        kl = 0.0
    if reduction == "mean":
        return (discrimloss.mean() + l1LossCoeff * l1norm.mean()
                + klLossCoeff * kl)
    return (_reduce(discrimloss, None) + l1LossCoeff * _reduce(l1norm, None)
            + klLossCoeff * kl)


def xavier_init_layer(generator, in_size, out_size):
    """A glorot-uniform ``Linear`` tree {"w" (in, out), "b" zeros}, drawn
    from a ``torch.Generator`` (``enhancement.py:222``; the JAX function
    takes a PRNG key).

    Example
    -------
    >>> import torch
    >>> p = xavier_init_layer(torch.Generator().manual_seed(0), 4, 3)
    >>> p["w"].shape, p["b"].tolist()
    ((4, 3), [0.0, 0.0, 0.0])
    """
    bound = math.sqrt(6.0 / (in_size + out_size))
    w = (torch.rand(in_size, out_size, generator=generator) * 2 - 1) * bound
    return {"w": w.numpy(), "b": np.zeros(out_size, np.float32)}


Generator = SeganGenerator

"""ECAPA-TDNN speaker embeddings (port of
``svt_speechbrain_tpu/models/ecapa_tdnn.py``): Res2Net TDNN blocks with
squeeze-excitation, multi-layer feature aggregation and attentive
statistics pooling, and the cosine ``Classifier`` head.

The BatchNorm running statistics are buffers, updated by a training
forward and used in eval. The JAX modules thread them as a state tree that
keeps a ``TDNNBlock``'s statistics at the block's own path (and the
pooling's at the pooling's), so the blocks name their norm child
(``jax_state_child``) for ``convert_jax``."""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import BatchNorm1d


def _frame_mask(lengths, t, x):
    """The valid-frame count n = clip(round(lengths · t), 1, t) of each row
    (rounded half to even in f32, as ``jnp.round``) and the (B, t, 1) mask
    of frames below it, in ``x``'s dtype."""
    lengths = torch.as_tensor(lengths, device=x.device).float()
    n = torch.clamp(torch.round(lengths * t), 1, t)
    mask = torch.arange(t, device=x.device)[None, :, None] < n[:, None, None]
    return n.to(x.dtype), mask.to(x.dtype)


class TDNNBlock(nn.Module):
    """Reflect-padded "same" ``Conv1d`` → ReLU → ``BatchNorm1d``
    (``ecapa_tdnn.py:16``)."""

    jax_state_child = "norm"

    def __init__(self, in_channels, out_channels, kernel_size, dilation):
        super().__init__()
        self.conv = Conv1d(out_channels, kernel_size, in_channels,
                           dilation=dilation, padding="same",
                           padding_mode="reflect")
        self.norm = BatchNorm1d(out_channels)

    def forward(self, x, train=False):
        return self.norm(torch.relu(self.conv(x)), train=train)


class Res2NetBlock(nn.Module):
    """Hierarchical multi-scale TDNNs over ``scale`` channel groups
    (``ecapa_tdnn.py:38``): the first group passes, each next one adds the
    previous output before its ``TDNNBlock`` (children ``0``, ``1``,
    ...)."""

    def __init__(self, in_channels, out_channels, scale=8, kernel_size=3,
                 dilation=1):
        super().__init__()
        if in_channels % scale or out_channels % scale:
            raise ValueError("the channels must divide by scale")
        self.scale = scale
        for i in range(scale - 1):
            self.add_module(str(i), TDNNBlock(
                in_channels // scale, out_channels // scale, kernel_size,
                dilation))

    def forward(self, x, train=False):
        chunks = torch.chunk(x, self.scale, dim=-1)
        outs, y = [chunks[0]], None
        for i, (chunk, block) in enumerate(zip(chunks[1:], self.children())):
            y = block(chunk if i == 0 else chunk + y, train=train)
            outs.append(y)
        return torch.cat(outs, dim=-1)


class SEBlock(nn.Module):
    """Squeeze-excitation over the channels (``ecapa_tdnn.py:69``): the
    mean over each row's valid frames (all frames without ``lengths``) →
    1x1 conv, ReLU → 1x1 conv, sigmoid → a gate on every frame."""

    def __init__(self, in_channels, se_channels, out_channels):
        super().__init__()
        self.conv1 = Conv1d(se_channels, 1, in_channels, padding="valid")
        self.conv2 = Conv1d(out_channels, 1, se_channels, padding="valid")

    def forward(self, x, lengths=None):
        if lengths is not None:
            n, mask = _frame_mask(lengths, x.shape[1], x)
            s = (x * mask).sum(dim=1, keepdim=True) / n[:, None, None]
        else:
            s = x.mean(dim=1, keepdim=True)
        s = torch.sigmoid(self.conv2(torch.relu(self.conv1(s))))
        return x * s


class AttentiveStatisticsPooling(nn.Module):
    """Attention-weighted mean and std over time (``ecapa_tdnn.py:93``):
    with ``global_context`` the attention's ``TDNNBlock`` reads x beside
    the masked mean and std of the row; masked logits are -1e30 before the
    softmax over time; std = sqrt(Σ w (x - mean)² + 1e-12). (B, T, C) →
    (B, 1, 2C)."""

    jax_state_child = "tdnn"

    def __init__(self, channels, attention_channels=128, global_context=True):
        super().__init__()
        self.global_context = global_context
        in_c = channels * 3 if global_context else channels
        self.tdnn = TDNNBlock(in_c, attention_channels, 1, 1)
        self.conv = Conv1d(channels, 1, attention_channels, padding="valid")
        self.eps = 1e-12

    def _stats(self, x, w):
        mean = (x * w).sum(dim=1, keepdim=True)
        std = torch.sqrt(((x - mean).square() * w).sum(dim=1, keepdim=True)
                         + self.eps)
        return mean, std

    def forward(self, x, lengths=None, train=False):
        t = x.shape[1]
        if lengths is None:
            lengths = torch.ones(x.shape[0])
        n, mask = _frame_mask(lengths, t, x)
        if self.global_context:
            mean, std = self._stats(x, mask / n[:, None, None])
            attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)],
                                dim=-1)
        else:
            attn_in = x
        attn = self.conv(torch.tanh(self.tdnn(attn_in, train=train)))
        attn = torch.where(mask > 0, attn, torch.full_like(attn, -1e30))
        mean, std = self._stats(x, torch.softmax(attn, dim=1))
        return torch.cat([mean[:, 0], std[:, 0]], dim=-1)[:, None, :]


class SERes2NetBlock(nn.Module):
    """``TDNNBlock`` → ``Res2NetBlock`` → ``TDNNBlock`` → ``SEBlock``, with
    a residual (through a 1x1 ``shortcut`` conv when the widths differ)
    (``ecapa_tdnn.py:140``)."""

    def __init__(self, in_channels, out_channels, res2net_scale=8,
                 se_channels=128, kernel_size=1, dilation=1):
        super().__init__()
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1, 1)
        self.res2net = Res2NetBlock(out_channels, out_channels,
                                    res2net_scale, kernel_size, dilation)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1, 1)
        self.se = SEBlock(out_channels, se_channels, out_channels)
        self.shortcut = (Conv1d(out_channels, 1, in_channels, padding="valid")
                         if in_channels != out_channels else None)

    def forward(self, x, lengths=None, train=False):
        residual = x if self.shortcut is None else self.shortcut(x)
        y = self.tdnn1(x, train=train)
        y = self.res2net(y, train=train)
        y = self.tdnn2(y, train=train)
        return self.se(y, lengths) + residual


class ECAPA_TDNN(nn.Module):
    """ECAPA-TDNN (``ecapa_tdnn.py:183``): (B, T, F) features → (B, 1,
    lin_neurons) embeddings. Children ``block0``, ``block1``..., ``mfa``,
    ``asp``, ``asp_norm``, ``fc``, named as the JAX tree.

    Example
    -------
    >>> import torch
    >>> model = ECAPA_TDNN(input_size=24, lin_neurons=32,
    ...                    channels=(32, 32, 32, 32, 96),
    ...                    attention_channels=16, res2net_scale=4,
    ...                    se_channels=16)
    >>> model(torch.ones(2, 40, 24)).shape
    torch.Size([2, 1, 32])
    """

    def __init__(self, input_size, lin_neurons=192,
                 channels=(512, 512, 512, 512, 1536),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=128, res2net_scale=8, se_channels=128,
                 global_context=True):
        super().__init__()
        self.block0 = TDNNBlock(input_size, channels[0], kernel_sizes[0],
                                dilations[0])
        self.n_blocks = len(channels) - 2
        for i in range(1, len(channels) - 1):
            self.add_module(f"block{i}", SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale, se_channels,
                kernel_sizes[i], dilations[i]))
        self.mfa = TDNNBlock(channels[-2] * self.n_blocks, channels[-1],
                             kernel_sizes[-1], dilations[-1])
        self.asp = AttentiveStatisticsPooling(channels[-1],
                                              attention_channels,
                                              global_context)
        self.asp_norm = BatchNorm1d(channels[-1] * 2)
        self.fc = Conv1d(lin_neurons, 1, channels[-1] * 2, padding="valid")

    def forward(self, x, lengths=None, train=False):
        h = self.block0(x, train=train)
        outs = []
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"block{i}")(h, lengths=lengths, train=train)
            outs.append(h)
        h = self.mfa(torch.cat(outs, dim=-1), train=train)
        h = self.asp(h, lengths=lengths, train=train)
        return self.fc(self.asp_norm(h, train=train))


class Classifier(nn.Module):
    """Cosine classifier for speaker identities (``ecapa_tdnn.py:264``):
    ``fc``, then the cosine of the L2-normalized embedding with each
    L2-normalized row of ``weight`` (out_neurons, lin_neurons); 1e-9 is
    added to each norm, not to its square."""

    def __init__(self, input_size, lin_neurons=192, out_neurons=1211):
        super().__init__()
        self.fc = Linear(lin_neurons, input_size)
        self.out_neurons = out_neurons
        self.lin_neurons = lin_neurons
        self.weight = nn.Parameter(torch.zeros(out_neurons, lin_neurons))

    def forward(self, x):
        x = self.fc(x)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)
        w = self.weight
        w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-9)
        return torch.matmul(x, w.t().to(x.dtype))

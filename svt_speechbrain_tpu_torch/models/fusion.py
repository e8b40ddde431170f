"""Residual cross-attention (RCA) audio-visual fusion (port of
``svt_speechbrain_tpu/models/fusion.py``).

- ``RCALayer``: one multi-head attention shared by self-attention on the
  key/value stream and cross-attention from the other stream's queries,
  run as ONE attention call on the stacked queries ``[src; src_q]`` against
  the same keys and values, as the JAX package runs it; combined as
  ``src_kv + α·self + (1−α)·cross``, then the FFN, with LayerNorms after
  (or, with ``normalize_before``, before) each block;
- ``RCANet``: sinusoidal positions on both streams, ``layer1`` (keys and
  values from stream 1, queries from stream 2) and ``layer2`` (the other
  way round);
- ``FusionRCA``: truncates or zero-pads the video to the audio's frame
  count (a warning when they differ by more than 15 frames), then sums the
  two fused streams.

The attention runs the eager path, as the JAX module's does (there it
asks for the head-averaged weights, which it then drops; here it names
``impl="eager"``): the fusion's head dim, 128 at ``d_model`` 1024 and 8
heads, is no kernel's. Its projections and FFN
products are cuBLAS, or kernel 5 after ``models.quantize.quantize_fusion``.
"""
from __future__ import annotations

import logging

import torch
from torch import nn

from svt_speechbrain_tpu_torch.models.transformer import PositionalEncoding
from svt_speechbrain_tpu_torch.nnet.attention import (
    MultiheadAttention, PositionalwiseFeedForward)
from svt_speechbrain_tpu_torch.nnet.dropout import dropout as _dropout
from svt_speechbrain_tpu_torch.nnet.normalization import LayerNorm

logger = logging.getLogger(__name__)


class RCALayer(nn.Module):
    """Shared-weight self and cross attention with an α residual
    (``fusion.py:36``); ``rng`` is a ``StepRNG``.

    Example
    -------
    >>> layer = RCALayer(d_ffn=32, nhead=4, d_model=16, alpha=0.5)
    >>> audio, video = torch.ones(2, 10, 16), torch.ones(2, 10, 16)
    >>> layer(audio, video).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, d_ffn, nhead, d_model, alpha=0.5, kdim=None, vdim=None,
                 dropout=0.0, activation="relu", normalize_before=False):
        super().__init__()
        self.alpha = alpha
        self.self_att = MultiheadAttention(nhead, d_model, dropout=dropout,
                                           kdim=kdim, vdim=vdim)
        self.pos_ffn = PositionalwiseFeedForward(d_ffn, d_model,
                                                 dropout=dropout,
                                                 activation=activation)
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.norm2 = LayerNorm(d_model, eps=1e-6)
        self.dropout = dropout
        self.normalize_before = normalize_before

    def forward(self, src_kv, src_q, src_mask=None, src_key_padding_mask=None,
                pos_embs=None, rng=None, train=False):
        gen = None if rng is None else rng.device
        if self.normalize_before:
            src = self.norm1(src_kv)
            src_q = self.norm1(src_q)
        else:
            src = src_kv
        t = src.shape[1]
        out = self.self_att(torch.cat([src, src_q], dim=1), src, src,
                            attn_mask=src_mask,
                            key_padding_mask=src_key_padding_mask,
                            pos_embs=pos_embs, rng=rng, train=train,
                            impl="eager")
        self_out, cross_out = out[:, :t], out[:, t:]
        src = (src_kv
               + _dropout(self_out, self.dropout, gen, train) * self.alpha
               + _dropout(cross_out, self.dropout, gen, train)
               * (1 - self.alpha))
        if self.normalize_before:
            src = self.norm2(src)
        else:
            src = self.norm1(src)
        output = src + _dropout(self.pos_ffn(src, rng=rng, train=train),
                                self.dropout, gen, train)
        if not self.normalize_before:
            output = self.norm2(output)
        return output


class RCANet(nn.Module):
    """Two RCA layers over two streams (``fusion.py:101``): returns
    (stream 1 fused, stream 2 fused)."""

    def __init__(self, nhead, d_ffn, alpha=0.5, d_model=None, kdim=None,
                 vdim=None, dropout=0.0, activation="relu",
                 normalize_before=False, max_length=2500):
        super().__init__()
        self.positional_encoding = PositionalEncoding(d_model, max_length)
        self.layer1 = RCALayer(d_ffn, nhead, d_model, alpha, kdim, vdim,
                               dropout, activation, normalize_before)
        self.layer2 = RCALayer(d_ffn, nhead, d_model, alpha, kdim, vdim,
                               dropout, activation, normalize_before)

    def forward(self, src1, src2, src_mask=None, src_key_padding_mask=None,
                pos_embs=None, rng=None, train=False):
        src1 = src1 + self.positional_encoding(src1)
        src2 = src2 + self.positional_encoding(src2)
        kwargs = dict(src_mask=src_mask,
                      src_key_padding_mask=src_key_padding_mask,
                      pos_embs=pos_embs, rng=rng, train=train)
        return (self.layer1(src_kv=src1, src_q=src2, **kwargs),
                self.layer2(src_kv=src2, src_q=src1, **kwargs))


class FusionRCA(nn.Module):
    """Frame-align, then fuse the audio and video feature streams
    (``fusion.py:133``): (B, Ta, d) and (B, Tv, d) → (B, Ta, d).

    Example
    -------
    >>> fusion = FusionRCA(alpha=0.5, nhead=4, d_ffn=32, d_model=16)
    >>> fusion(torch.ones(2, 10, 16), torch.ones(2, 12, 16)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, alpha=0.5, nhead=8, d_ffn=3072, d_model=1024):
        super().__init__()
        self.fusion = RCANet(alpha=alpha, nhead=nhead, d_ffn=d_ffn,
                             d_model=d_model)

    def forward(self, audio_feats, video_feats, rng=None, train=False):
        diff = audio_feats.shape[1] - video_feats.shape[1]
        if diff < 0:
            video_feats = video_feats[:, :diff]
        elif diff > 0:
            pad = video_feats.new_zeros(video_feats.shape[0], diff,
                                        video_feats.shape[2])
            video_feats = torch.cat([video_feats, pad], dim=1)
        if abs(diff) > 15:
            logger.warning("Alignment is wrong")
        audio_out, video_out = self.fusion(audio_feats, video_feats, rng=rng,
                                           train=train)
        return audio_out + video_out

"""Transformer lobes (port of ``svt_speechbrain_tpu/models/transformer.py``):
the sinusoidal ``PositionalEncoding`` and the two mask helpers (the fusion
network uses them), the encoder and decoder layers and stacks, pre- or
post-LN, ``NormalizedEmbedding`` and ``TransformerInterface``.

The layers call ``MultiheadAttention`` for its head-averaged weights, as
the JAX layers do (its default there), so their attention keeps the JAX
dispatch: the eager path, never a kernel. Dropout draws from the step's
``StepRNG`` (``rng``) in training."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.attention import (
    MultiheadAttention, PositionalwiseFeedForward)
from svt_speechbrain_tpu_torch.nnet.dropout import dropout as _dropout
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.normalization import LayerNorm


def _drop(x, rate, rng, train):
    return _dropout(x, rate, None if rng is None else rng.device, train)


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


class TransformerEncoderLayer(nn.Module):
    """Post- or pre-LN encoder layer (``transformer.py:59``): self-attention
    and the position-wise FFN, each with dropout on its residual branch;
    ``forward`` → (output, head-averaged attention weights).

    Example
    -------
    >>> import torch
    >>> layer = TransformerEncoderLayer(d_ffn=32, nhead=4, d_model=16)
    >>> out, attn = layer(torch.ones(2, 5, 16))
    >>> out.shape, attn.shape
    (torch.Size([2, 5, 16]), torch.Size([2, 5, 5]))
    """

    def __init__(self, d_ffn, nhead, d_model, kdim=None, vdim=None,
                 dropout=0.0, activation="relu", normalize_before=False):
        super().__init__()
        self.self_att = MultiheadAttention(nhead, d_model, dropout=dropout,
                                           kdim=kdim, vdim=vdim)
        self.pos_ffn = PositionalwiseFeedForward(d_ffn, d_model,
                                                 dropout=dropout,
                                                 activation=activation)
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.norm2 = LayerNorm(d_model, eps=1e-6)
        self.dropout = dropout
        self.normalize_before = normalize_before

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                pos_embs=None, rng=None, train=False):
        src1 = self.norm1(src) if self.normalize_before else src
        output, attn = self.self_att(
            src1, src1, src1, attn_mask=src_mask,
            key_padding_mask=src_key_padding_mask, pos_embs=pos_embs,
            rng=rng, train=train, return_attn_weights=True)
        src = src + _drop(output, self.dropout, rng, train)
        if not self.normalize_before:
            src = self.norm1(src)
        src1 = self.norm2(src) if self.normalize_before else src
        output = self.pos_ffn(src1, rng=rng, train=train)
        output = src + _drop(output, self.dropout, rng, train)
        if not self.normalize_before:
            output = self.norm2(output)
        return output, attn


class TransformerEncoder(nn.Module):
    """Encoder stack (``transformer.py:103``): ``layers`` then a final
    ``norm``; → (output, the layers' attention weights).

    Example
    -------
    >>> import torch
    >>> enc = TransformerEncoder(num_layers=2, nhead=4, d_ffn=64, d_model=32)
    >>> out, attns = enc(torch.ones(2, 10, 32))
    >>> out.shape, len(attns), attns[0].shape
    (torch.Size([2, 10, 32]), 2, torch.Size([2, 10, 10]))
    """

    def __init__(self, num_layers, nhead, d_ffn, input_shape=None,
                 d_model=None, kdim=None, vdim=None, dropout=0.0,
                 activation="relu", normalize_before=False):
        super().__init__()
        if d_model is None and input_shape is not None:
            d_model = input_shape[-1]
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_ffn, nhead, d_model, kdim, vdim,
                                    dropout, activation, normalize_before)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                pos_embs=None, rng=None, train=False):
        attns = []
        for layer in self.layers:
            src, attn = layer(src, src_mask, src_key_padding_mask, pos_embs,
                              rng, train)
            attns.append(attn)
        return self.norm(src), attns


class TransformerDecoderLayer(nn.Module):
    """Decoder layer (``transformer.py:143``): masked self-attention,
    cross-attention over the encoder memory (``mutihead_attn``, the JAX
    key) and the FFN, post- or pre-LN; → (output, self-attention weights,
    cross-attention weights)."""

    def __init__(self, d_ffn, nhead, d_model, kdim=None, vdim=None,
                 dropout=0.0, activation="relu", normalize_before=False):
        super().__init__()
        self.self_attn = MultiheadAttention(nhead, d_model, dropout=dropout)
        self.mutihead_attn = MultiheadAttention(nhead, d_model,
                                                dropout=dropout, kdim=kdim,
                                                vdim=vdim)
        self.pos_ffn = PositionalwiseFeedForward(d_ffn, d_model,
                                                 dropout=dropout,
                                                 activation=activation)
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.norm2 = LayerNorm(d_model, eps=1e-6)
        self.norm3 = LayerNorm(d_model, eps=1e-6)
        self.dropout = dropout
        self.normalize_before = normalize_before

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                rng=None, train=False):
        pre = self.normalize_before
        tgt1 = self.norm1(tgt) if pre else tgt
        out, self_attn = self.self_attn(
            tgt1, tgt1, tgt1, attn_mask=tgt_mask,
            key_padding_mask=tgt_key_padding_mask, rng=rng, train=train,
            return_attn_weights=True)
        tgt = tgt + _drop(out, self.dropout, rng, train)
        if not pre:
            tgt = self.norm1(tgt)
        tgt1 = self.norm2(tgt) if pre else tgt
        out, cross_attn = self.mutihead_attn(
            tgt1, memory, memory, attn_mask=memory_mask,
            key_padding_mask=memory_key_padding_mask, rng=rng, train=train,
            return_attn_weights=True)
        tgt = tgt + _drop(out, self.dropout, rng, train)
        if not pre:
            tgt = self.norm2(tgt)
        tgt1 = self.norm3(tgt) if pre else tgt
        out = self.pos_ffn(tgt1, rng=rng, train=train)
        tgt = tgt + _drop(out, self.dropout, rng, train)
        if not pre:
            tgt = self.norm3(tgt)
        return tgt, self_attn, cross_attn


class TransformerDecoder(nn.Module):
    """Decoder stack (``transformer.py:202``): ``layers`` then a final
    ``norm``; → (output, self-attention weights, cross-attention weights)
    of every layer.

    Example
    -------
    >>> import torch
    >>> dec = TransformerDecoder(1, nhead=2, d_ffn=16, d_model=8)
    >>> out, sa, ca = dec(torch.ones(2, 3, 8), torch.ones(2, 7, 8))
    >>> out.shape, ca[0].shape
    (torch.Size([2, 3, 8]), torch.Size([2, 3, 7]))
    """

    def __init__(self, num_layers, nhead, d_ffn, d_model, kdim=None,
                 vdim=None, dropout=0.0, activation="relu",
                 normalize_before=False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_ffn, nhead, d_model, kdim, vdim,
                                    dropout, activation, normalize_before)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                rng=None, train=False):
        self_attns, cross_attns = [], []
        for layer in self.layers:
            tgt, sa, ca = layer(tgt, memory, tgt_mask, memory_mask,
                                tgt_key_padding_mask,
                                memory_key_padding_mask, rng, train)
            self_attns.append(sa)
            cross_attns.append(ca)
        return self.norm(tgt), self_attns, cross_attns


class NormalizedEmbedding(Embedding):
    """Token embedding scaled by sqrt(d_model) (``transformer.py:231``);
    its ``table`` sits at the module's own path, as in the JAX tree.

    Example
    -------
    >>> import torch
    >>> NormalizedEmbedding(16, 10)(torch.tensor([[1, 2]])).shape
    torch.Size([1, 2, 16])
    """

    def __init__(self, d_model, vocab):
        super().__init__(vocab, d_model)
        self.d_model = d_model

    def forward(self, x):
        return super().forward(x) * math.sqrt(self.d_model)


class TransformerInterface(nn.Module):
    """The encoder (and decoder) assembly (``transformer.py:250``): a
    transformer or conformer encoder by ``encoder_module``, a decoder when
    ``num_decoder_layers`` > 0, and the positional encoding; the shared
    backbone of the transformer models.

    Example
    -------
    >>> m = TransformerInterface(d_model=16, nhead=4, num_encoder_layers=1,
    ...                          num_decoder_layers=1, d_ffn=32)
    >>> sorted(name for name, _ in m.named_children())
    ['decoder', 'encoder', 'positional_encoding']
    """

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, d_ffn=2048, dropout=0.1,
                 encoder_module="transformer", kernel_size=31,
                 attention_type="regularMHA",
                 positional_encoding="fixed_abs_sine", max_length=2500,
                 causal=False):
        super().__init__()
        self.encoder_module = encoder_module
        self.positional_encoding = (
            PositionalEncoding(d_model, max_len=max_length)
            if positional_encoding else None)
        if encoder_module == "conformer":
            from svt_speechbrain_tpu_torch.models.conformer import (
                ConformerEncoder)

            self.encoder = ConformerEncoder(
                num_encoder_layers, d_model=d_model, d_ffn=d_ffn,
                nhead=nhead, kernel_size=kernel_size, dropout=dropout,
                causal=causal)
        else:
            self.encoder = TransformerEncoder(num_encoder_layers, nhead,
                                              d_ffn, d_model=d_model,
                                              dropout=dropout)
        self.decoder = (TransformerDecoder(num_decoder_layers, nhead, d_ffn,
                                           d_model=d_model, dropout=dropout)
                        if num_decoder_layers > 0 else None)

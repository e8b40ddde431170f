"""Conformer encoder and decoder (port of
``svt_speechbrain_tpu/models/conformer.py``).

The children carry the JAX tree's keys: a ``ConformerEncoder``'s layers
are its children ``"0"``, ``"1"``, ... (the JAX tree ``{str(i): layer}``),
a layer's ``mha``, ``conv``, ``ffn1_a``/``ffn1_b``, ``ffn2_a``/``ffn2_b``
and the four norms. The convolution module's ``BatchNorm1d`` keeps its
running statistics in buffers, updated in training; the JAX state tree
holds them at the convolution module's path (``jax_state_child``), where
``convert_jax`` reads and writes them.
"""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.activations import Swish
from svt_speechbrain_tpu_torch.nnet.attention import (MultiheadAttention,
                                                      RelPosEncXL,
                                                      RelPosMHAXL)
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d
from svt_speechbrain_tpu_torch.nnet.dropout import dropout as _dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (BatchNorm1d,
                                                          LayerNorm)


def _drop(x, rate, rng, train):
    return _dropout(x, rate, None if rng is None else rng.device, train)


class ConvolutionModule(nn.Module):
    """LayerNorm → pointwise → GLU → depthwise conv → BatchNorm → Swish →
    pointwise (``conformer.py:16``), channel-last; the depthwise conv is
    "causal" or "same".

    Example
    -------
    >>> import torch
    >>> ConvolutionModule(8, kernel_size=5)(torch.ones(2, 6, 8)).shape
    torch.Size([2, 6, 8])
    """

    jax_state_child = "norm"

    def __init__(self, input_size, kernel_size=31, bias=True, causal=False,
                 dilation=1):
        super().__init__()
        self.causal = causal
        self.pre_norm = LayerNorm(input_size)
        self.pw1 = Linear(2 * input_size, input_size, bias=bias)
        self.dw = Conv1d(input_size, kernel_size, input_size,
                         groups=input_size,
                         padding="causal" if causal else "same",
                         dilation=dilation, bias=bias)
        self.norm = BatchNorm1d(input_size)
        self.pw2 = Linear(input_size, input_size, bias=bias)

    def forward(self, x, train=False):
        h = self.pw1(self.pre_norm(x))
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)                                    # GLU
        h = self.norm(self.dw(h), train=train)
        h = h * torch.sigmoid(h)                                    # swish
        return self.pw2(h)


class ConformerEncoderLayer(nn.Module):
    """Half FFN → relative-position (or regular) self-attention → the
    convolution module → half FFN → LayerNorm (``conformer.py:56``), each
    a residual branch; dropout inside the FFNs, in the attention and on
    its output.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.attention import RelPosEncXL
    >>> layer = ConformerEncoderLayer(8, 16, 2, kernel_size=3)
    >>> x = torch.ones(2, 5, 8)
    >>> layer(x, pos_embs=RelPosEncXL(8)(x)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, d_model, d_ffn, nhead, kernel_size=31, dropout=0.0,
                 causal=False, attention_type="RelPosMHAXL"):
        super().__init__()
        self.attention_type = attention_type
        if attention_type == "RelPosMHAXL":
            self.mha = RelPosMHAXL(d_model, nhead, dropout,
                                   mask_pos_future=causal)
        else:
            self.mha = MultiheadAttention(nhead, d_model, dropout=dropout)
        self.conv = ConvolutionModule(d_model, kernel_size, causal=causal)
        self.ffn1_a = Linear(d_ffn, d_model)
        self.ffn1_b = Linear(d_model, d_ffn)
        self.ffn2_a = Linear(d_ffn, d_model)
        self.ffn2_b = Linear(d_model, d_ffn)
        self.norm_ff1 = LayerNorm(d_model)
        self.norm_mha = LayerNorm(d_model)
        self.norm_ff2 = LayerNorm(d_model)
        self.norm_out = LayerNorm(d_model)
        self.dropout = dropout
        self.swish = Swish()

    def _half_ffn(self, x, which, rng, train):
        norm = getattr(self, f"norm_ff{which}")
        y = self.swish(getattr(self, f"ffn{which}_a")(norm(x)))
        y = _drop(y, self.dropout, rng, train)
        return getattr(self, f"ffn{which}_b")(y)

    def forward(self, x, pos_embs=None, src_key_padding_mask=None, rng=None,
                train=False):
        x = x + 0.5 * self._half_ffn(x, 1, rng, train)
        h = self.norm_mha(x)
        if self.attention_type == "RelPosMHAXL":
            attn_out, _ = self.mha(h, h, h, pos_embs,
                                   key_padding_mask=src_key_padding_mask,
                                   rng=rng, train=train)
        else:
            attn_out, _ = self.mha(h, h, h,
                                   key_padding_mask=src_key_padding_mask,
                                   rng=rng, train=train,
                                   return_attn_weights=True)
        x = x + _drop(attn_out, self.dropout, rng, train)
        x = x + self.conv(x, train=train)
        x = x + 0.5 * self._half_ffn(x, 2, rng, train)
        return self.norm_out(x)


class ConformerEncoder(nn.Module):
    """Conformer encoder stack (``conformer.py:133``): the layers are the
    children ``"0"``, ``"1"``, ...; the relative positions of the input's
    length are computed once and shared.

    Example
    -------
    >>> import torch
    >>> enc = ConformerEncoder(num_layers=2, d_model=32, d_ffn=64, nhead=4,
    ...                        kernel_size=7)
    >>> enc(torch.ones(2, 12, 32)).shape
    torch.Size([2, 12, 32])
    """

    def __init__(self, num_layers, d_model, d_ffn, nhead, kernel_size=31,
                 dropout=0.0, causal=False, attention_type="RelPosMHAXL"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(str(i), ConformerEncoderLayer(
                d_model, d_ffn, nhead, kernel_size, dropout, causal,
                attention_type))
        self.pos_enc = (RelPosEncXL(d_model)
                        if attention_type == "RelPosMHAXL" else None)
        self.attention_type = attention_type

    def forward(self, x, src_key_padding_mask=None, rng=None, train=False):
        pos_embs = self.pos_enc(x) if self.pos_enc is not None else None
        for i in range(self.num_layers):
            x = getattr(self, str(i))(
                x, pos_embs=pos_embs,
                src_key_padding_mask=src_key_padding_mask, rng=rng,
                train=train)
        return x


class ConformerDecoderLayer(nn.Module):
    """Causal conformer decoder layer (``conformer.py:174``): the encoder
    layer's parts (``inner``, causal, regular attention) with look-ahead
    masked self-attention, plus a cross-attention block (``cross``,
    ``norm_cross``) over the encoder memory. As in the JAX layer, the
    FFNs take no dropout, the self-attention's branch is added beside the
    first half FFN, and the convolution module normalizes with its running
    statistics.

    Example
    -------
    >>> import torch
    >>> layer = ConformerDecoderLayer(8, 16, 2, kernel_size=3)
    >>> layer(torch.ones(2, 4, 8), torch.ones(2, 6, 8)).shape
    torch.Size([2, 4, 8])
    """

    def __init__(self, d_model, d_ffn, nhead, kernel_size=31, dropout=0.0):
        super().__init__()
        self.inner = ConformerEncoderLayer(d_model, d_ffn, nhead,
                                           kernel_size=kernel_size,
                                           dropout=dropout, causal=True,
                                           attention_type="regularMHA")
        self.cross = MultiheadAttention(nhead, d_model, dropout=dropout)
        self.norm_cross = LayerNorm(d_model)
        self.dropout = dropout

    def forward(self, tgt, memory, memory_key_padding_mask=None, rng=None,
                train=False):
        t = tgt.shape[1]
        future = torch.triu(torch.ones(t, t, dtype=torch.bool,
                                       device=tgt.device), diagonal=1)
        inner = self.inner
        h = inner.norm_mha(tgt)
        attn_out, _ = inner.mha(h, h, h, attn_mask=future, rng=rng,
                                train=train, return_attn_weights=True)
        x = tgt + 0.5 * inner._half_ffn(tgt, 1, None, train)
        x = x + attn_out
        hc = self.norm_cross(x)
        x = x + self.cross(hc, memory, memory,
                           key_padding_mask=memory_key_padding_mask, rng=rng,
                           train=train)
        x = x + inner.conv(x)
        x = x + 0.5 * inner._half_ffn(x, 2, None, train)
        return inner.norm_out(x)


class ConformerDecoder(nn.Module):
    """Stack of causal conformer decoder layers (``conformer.py:219``), the
    children ``"0"``, ``"1"``, ...

    Example
    -------
    >>> import torch
    >>> dec = ConformerDecoder(2, nhead=2, d_ffn=16, d_model=8, kernel_size=3)
    >>> dec(torch.ones(2, 4, 8), torch.ones(2, 6, 8)).shape
    torch.Size([2, 4, 8])
    """

    def __init__(self, num_layers, nhead, d_ffn, d_model, kernel_size=31,
                 dropout=0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(str(i), ConformerDecoderLayer(
                d_model, d_ffn, nhead, kernel_size=kernel_size,
                dropout=dropout))

    def forward(self, tgt, memory, memory_key_padding_mask=None, rng=None,
                train=False):
        for i in range(self.num_layers):
            tgt = getattr(self, str(i))(
                tgt, memory, memory_key_padding_mask=memory_key_padding_mask,
                rng=rng, train=train)
        return tgt

"""Transformer ASR and LM lobes (port of
``svt_speechbrain_tpu/models/transformer_asr.py``)."""
from __future__ import annotations

import math

import torch
from torch import nn

from svt_speechbrain_tpu_torch.models.conformer import ConformerEncoder
from svt_speechbrain_tpu_torch.models.transformer import (
    PositionalEncoding, TransformerDecoder, TransformerEncoder,
    get_lookahead_mask)
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear


class TransformerASR(nn.Module):
    """Input projection, encoder and decoder (``transformer_asr.py:21``):
    ``encoder_module`` "transformer" (sinusoidal positions added to the
    projected input) or "conformer" (relative positions inside). The
    children are the JAX tree's keys: ``src`` (the input ``Linear``),
    ``tgt`` (the token ``Embedding``), ``encoder``, ``decoder``.

    ``encode(src, wav_len=None, rng=None, train=False)`` → (encoder
    output, key padding mask or None): the mask is True from frame
    round(wav_len · T) on, rounded half to even. ``decode(tgt,
    encoder_out, enc_kpm=None, rng=None, train=False)`` adds the
    sinusoidal positions to the embedded tokens and runs the look-ahead
    masked decoder. ``forward(src, tgt, wav_len=None, pad_idx=0, rng=None,
    train=False)`` → (encoder output, decoder output).

    The conformer's ``BatchNorm1d`` statistics are updated in training and
    used in eval, as the reference's are; the JAX module never threads
    that state, so its eval normalizes with the initial statistics (mean
    0, variance 1) and the two agree in eval only there.

    Example
    -------
    >>> import torch
    >>> m = TransformerASR(tgt_vocab=11, input_size=20, d_model=16, nhead=4,
    ...                    num_encoder_layers=1, num_decoder_layers=1,
    ...                    d_ffn=32)
    >>> enc, dec = m(torch.ones(2, 7, 20), torch.ones(2, 5, dtype=torch.long))
    >>> enc.shape, dec.shape
    (torch.Size([2, 7, 16]), torch.Size([2, 5, 16]))
    """

    def __init__(self, tgt_vocab, input_size, d_model=512, nhead=8,
                 num_encoder_layers=6, num_decoder_layers=6, d_ffn=2048,
                 dropout=0.1, activation="relu", normalize_before=False,
                 encoder_module="transformer", kernel_size=31,
                 max_length=2500):
        super().__init__()
        self.src = Linear(d_model, input_size)
        self.tgt = Embedding(tgt_vocab, d_model)
        self.positional_encoding = PositionalEncoding(d_model, max_length)
        if encoder_module == "conformer":
            self.encoder = ConformerEncoder(num_encoder_layers, d_model,
                                            d_ffn, nhead, kernel_size,
                                            dropout)
        else:
            self.encoder = TransformerEncoder(
                num_encoder_layers, nhead, d_ffn, d_model=d_model,
                dropout=dropout, activation=activation,
                normalize_before=normalize_before)
        self.decoder = TransformerDecoder(
            num_decoder_layers, nhead, d_ffn, d_model, dropout=dropout,
            activation=activation, normalize_before=normalize_before)
        self.encoder_module = encoder_module

    def encode(self, src, wav_len=None, rng=None, train=False):
        h = self.src(src)
        kpm = None
        if wav_len is not None:
            t = h.shape[1]
            wav_len = torch.as_tensor(wav_len, device=h.device)
            n = torch.round(wav_len.float() * t)
            kpm = torch.arange(t, device=h.device)[None, :] >= n[:, None]
        if self.encoder_module == "conformer":
            return self.encoder(h, src_key_padding_mask=kpm, rng=rng,
                                train=train), kpm
        h = h + self.positional_encoding(h)
        out, _ = self.encoder(h, src_key_padding_mask=kpm, rng=rng,
                              train=train)
        return out, kpm

    def decode(self, tgt, encoder_out, enc_kpm=None, rng=None, train=False):
        e = self.tgt(tgt)
        e = e + self.positional_encoding(e)
        out, _, _ = self.decoder(e, encoder_out,
                                 tgt_mask=get_lookahead_mask(tgt),
                                 memory_key_padding_mask=enc_kpm, rng=rng,
                                 train=train)
        return out

    def forward(self, src, tgt, wav_len=None, pad_idx=0, rng=None,
                train=False):
        encoder_out, kpm = self.encode(src, wav_len, rng, train)
        return encoder_out, self.decode(tgt, encoder_out, kpm, rng, train)


class TransformerLM(nn.Module):
    """Decoder-only transformer LM (``transformer_asr.py:86``): the token
    embedding scaled by sqrt(d_model), sinusoidal positions, a look-ahead
    masked ``TransformerEncoder`` and the output ``Linear`` to per-token
    logits.

    Example
    -------
    >>> import torch
    >>> lm = TransformerLM(vocab=11, d_model=16, nhead=4,
    ...                    num_encoder_layers=1, d_ffn=32)
    >>> lm(torch.ones(2, 5, dtype=torch.long)).shape
    torch.Size([2, 5, 11])
    """

    def __init__(self, vocab, d_model=512, nhead=8, num_encoder_layers=12,
                 d_ffn=2048, dropout=0.1, activation="relu",
                 normalize_before=False, max_length=2500):
        super().__init__()
        self.embedding = Embedding(vocab, d_model)
        self.positional_encoding = PositionalEncoding(d_model, max_length)
        self.encoder = TransformerEncoder(
            num_encoder_layers, nhead, d_ffn, d_model=d_model,
            dropout=dropout, activation=activation,
            normalize_before=normalize_before)
        self.out = Linear(vocab, d_model)
        self.d_model = d_model

    def forward(self, x, rng=None, train=False):
        e = self.embedding(x) * math.sqrt(self.d_model)
        e = e + self.positional_encoding(e)
        h, _ = self.encoder(e, src_mask=get_lookahead_mask(x), rng=rng,
                            train=train)
        return self.out(h)


class EncoderWrapper(nn.Module):
    """A ``TransformerASR``'s encode path as an encoder module
    (``transformer_asr.py:135``): ``forward(x, wav_lens=None)`` → the
    encoder output. The JAX tree of the wrapper is its transformer's, so
    it loads into ``wrapper.transformer``."""

    def __init__(self, transformer):
        super().__init__()
        self.transformer = transformer

    def forward(self, x, wav_lens=None, **kwargs):
        out, _ = self.transformer.encode(x, wav_len=wav_lens)
        return out


class TransformerASREncoder(nn.Module):
    """Waveforms → a ``TransformerASR``'s encoder states: the features, the
    input normalization with its stored statistics (``train=False``), the
    convolutional frontend and ``encode`` with the relative lengths — the
    ``encoder`` of SpeechBrain's transformer and conformer
    ``EncoderDecoderASR`` models (their yaml's ``LengthsCapableSequential``
    of ``compute_features``, ``normalize``, ``CNN`` and ``EncoderWrapper``).

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.models.convolution import (
    ...     ConvolutionFrontEnd)
    >>> from svt_speechbrain_tpu_torch.models.features import Fbank
    >>> from svt_speechbrain_tpu_torch.processing.features import (
    ...     InputNormalization)
    >>> front = ConvolutionFrontEnd(input_size=8, num_blocks=1,
    ...                             num_layers_per_block=1,
    ...                             out_channels=(4,), kernel_sizes=(3,),
    ...                             strides=(2,), residuals=(False,))
    >>> asr = TransformerASR(7, front.output_dim(), d_model=8, nhead=2,
    ...                      num_encoder_layers=1, num_decoder_layers=1,
    ...                      d_ffn=16)
    >>> enc = TransformerASREncoder(Fbank(n_mels=8), InputNormalization(),
    ...                             front, asr)
    >>> enc(torch.ones(2, 1600), lengths=torch.ones(2)).shape
    torch.Size([2, 6, 8])
    """

    def __init__(self, compute_features, normalize, frontend, transformer):
        super().__init__()
        self.compute_features = compute_features
        self.normalize = normalize
        self.frontend = frontend
        self.transformer = transformer

    def forward(self, wavs, lengths=None):
        if lengths is None:
            lengths = torch.ones(wavs.shape[0], device=wavs.device)
        feats = self.normalize(self.compute_features(wavs), lengths,
                               train=False)
        out, _ = self.transformer.encode(self.frontend(feats), wav_len=lengths)
        return out

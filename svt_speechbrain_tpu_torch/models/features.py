"""Feature lobes: the Fbank and MFCC pipelines (port of
``svt_speechbrain_tpu/models/features.py``)."""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.processing.features import (
    DCT, STFT, ContextWindow, Deltas, Filterbank, spectral_magnitude)


class Fbank(nn.Module):
    """Waveform (batch, samples) → log-mel filterbanks (batch, frames,
    n_mels) (``features.py:13``): STFT, power, mel filterbank in dB; with
    ``deltas`` the first and second deltas appended, with ``context`` the
    frames spliced.

    Example
    -------
    >>> import torch
    >>> Fbank(n_mels=40)(torch.zeros(2, 16000)).shape  # 10 ms hop, 1 s
    torch.Size([2, 101, 40])
    """

    def __init__(self, deltas=False, context=False, requires_grad=False,
                 sample_rate=16000, f_min=0, f_max=None, n_fft=400, n_mels=40,
                 filter_shape="triangular", param_change_factor=1.0,
                 param_rand_factor=0.0, left_frames=5, right_frames=5,
                 win_length=25, hop_length=10):
        super().__init__()
        if f_max is None:
            f_max = sample_rate / 2
        self.deltas = deltas
        self.context = context
        self.compute_STFT = STFT(sample_rate=sample_rate, n_fft=n_fft,
                                 win_length=win_length, hop_length=hop_length)
        self.compute_fbanks = Filterbank(
            sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max, filter_shape=filter_shape)
        self.compute_deltas = Deltas(input_size=n_mels)
        self.context_window = ContextWindow(left_frames=left_frames,
                                            right_frames=right_frames)

    def forward(self, wav):
        fbanks = self.compute_fbanks(spectral_magnitude(
            self.compute_STFT(wav)))
        if self.deltas:
            delta1 = self.compute_deltas(fbanks)
            delta2 = self.compute_deltas(delta1)
            fbanks = torch.cat([fbanks, delta1, delta2], dim=2)
        if self.context:
            fbanks = self.context_window(fbanks)
        return fbanks


class MFCC(nn.Module):
    """Waveform → MFCCs (``features.py:57``): the Fbank chain, the DCT to
    ``n_mfcc`` coefficients, deltas and context as in ``Fbank`` (both on by
    default).

    Example
    -------
    >>> import torch
    >>> MFCC()(torch.zeros(2, 16000)).shape         # 20 x 3 deltas x 11
    torch.Size([2, 101, 660])
    """

    def __init__(self, deltas=True, context=True, requires_grad=False,
                 sample_rate=16000, f_min=0, f_max=None, n_fft=400, n_mels=23,
                 n_mfcc=20, filter_shape="triangular", param_change_factor=1.0,
                 param_rand_factor=0.0, left_frames=5, right_frames=5,
                 win_length=25, hop_length=10):
        super().__init__()
        if f_max is None:
            f_max = sample_rate / 2
        self.deltas = deltas
        self.context = context
        self.compute_STFT = STFT(sample_rate=sample_rate, n_fft=n_fft,
                                 win_length=win_length, hop_length=hop_length)
        self.compute_fbanks = Filterbank(
            sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max, filter_shape=filter_shape)
        self.compute_dct = DCT(input_size=n_mels, n_out=n_mfcc)
        self.compute_deltas = Deltas(input_size=n_mfcc)
        self.context_window = ContextWindow(left_frames=left_frames,
                                            right_frames=right_frames)

    def forward(self, wav):
        mfccs = self.compute_dct(self.compute_fbanks(spectral_magnitude(
            self.compute_STFT(wav))))
        if self.deltas:
            delta1 = self.compute_deltas(mfccs)
            delta2 = self.compute_deltas(delta1)
            mfccs = torch.cat([mfccs, delta1, delta2], dim=2)
        if self.context:
            mfccs = self.context_window(mfccs)
        return mfccs

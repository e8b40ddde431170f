"""Multi-mic beamforming lobe (port of
``svt_speechbrain_tpu/models/beamform_multimic.py``, the analogue of
SpeechBrain's ``lobes/beamform_multimic.py``): STFT → covariance →
GCC-PHAT TDOA → delay-and-sum → ISTFT, on the device of the signals."""
from __future__ import annotations

from torch import nn

from svt_speechbrain_tpu_torch.processing.features import ISTFT, STFT
from svt_speechbrain_tpu_torch.processing.multi_mic import (Covariance,
                                                            DelaySum, GccPhat)


class DelaySum_Beamformer(nn.Module):
    """Multi-channel waveform (B, T, C) → beamformed mono waveform (B, T)
    (``beamform_multimic.py:12``).

    Example
    -------
    >>> import numpy as np, torch
    >>> src = np.random.default_rng(0).normal(size=4000).astype(np.float32)
    >>> sig = np.stack([src, np.roll(src, 3)], axis=-1)[None]  # mic1 lags 3
    >>> bf = DelaySum_Beamformer(sampling_rate=16000, tdoa_max=8)
    >>> out = bf(torch.from_numpy(sig))
    >>> out.shape
    torch.Size([1, 4000])
    >>> corr = np.corrcoef(out[0, 200:3800].numpy(), src[200:3800])[0, 1]
    >>> bool(corr > 0.99)      # aligned average reconstructs the source
    True
    """

    def __init__(self, sampling_rate=16000, tdoa_max=None):
        super().__init__()
        self.stft = STFT(sample_rate=sampling_rate)
        self.cov = Covariance()
        self.gccphat = GccPhat(tdoa_max=tdoa_max)
        self.delaysum = DelaySum()
        self.istft = ISTFT(sample_rate=sampling_rate)

    def forward(self, mics_signals):
        xs = self.stft(mics_signals)             # (B, T', F, 2, C)
        tdoas = self.gccphat(self.cov(xs))       # (B, T', P) fractional
        ys = self.delaysum(xs, tdoas)            # (B, T', F, 2, 1)
        return self.istft(ys[..., 0], sig_length=mics_signals.shape[1])

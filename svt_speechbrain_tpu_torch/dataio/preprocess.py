"""Audio preprocessing for dynamic pipelines (port of
``svt_speechbrain_tpu/dataio/preprocess.py``): ``AudioNormalizer`` on
tensors."""
from __future__ import annotations

from math import gcd

import numpy as np
import torch


class AudioNormalizer:
    """Resample to a target rate and mix channels (``preprocess.py:8``):
    the loader-side normalization of input audio. Takes a (T,) or (T, C)
    tensor (or anything ``torch.as_tensor`` reads) and returns a float32
    tensor on the input's device. Resampling is scipy's ``resample_poly``
    on the host, as in the JAX package, so both give the same samples.

    Example
    -------
    >>> import torch
    >>> norm = AudioNormalizer(sample_rate=16000)
    >>> stereo = torch.stack([torch.ones(80), torch.zeros(80)], dim=1)
    >>> out = norm(stereo, 8000)                 # 8 kHz stereo
    >>> tuple(out.shape), round(float(out.mean()), 2)
    ((160,), 0.5)
    """

    def __init__(self, sample_rate=16000, mix="avg-to-mono"):
        self.sample_rate = sample_rate
        if mix not in ("avg-to-mono", "keep"):
            raise ValueError(f"Unexpected mixing configuration {mix}")
        self.mix = mix

    def __call__(self, audio, sample_rate):
        """audio: (T,) or (T, C) → normalized (T',) or (T', C)."""
        audio = torch.as_tensor(audio).float()
        if sample_rate != self.sample_rate:
            from scipy.signal import resample_poly

            g = gcd(int(self.sample_rate), int(sample_rate))
            out = resample_poly(audio.cpu().numpy(),
                                int(self.sample_rate) // g,
                                int(sample_rate) // g, axis=0)
            audio = torch.from_numpy(out.astype(np.float32)).to(audio.device)
        return self._mix(audio)

    def _mix(self, audio):
        if self.mix == "avg-to-mono" and audio.dim() > 1:
            return audio.mean(dim=1)
        return audio

"""Augmentation lobes (port of ``svt_speechbrain_tpu/models/augment.py``):
``SpecAugment`` over spectrograms, and the waveform chains
``TimeDomainSpecAugment`` and ``EnvCorrupt`` over the augmenters of
``processing/speech_augmentation.py``. As there, each random step is a
draw from an explicit generator and a deterministic apply."""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.processing.speech_augmentation import (
    AddBabble, AddNoise, AddReverb, DropChunk, DropFreq, SpeedPerturb,
    _generator)


def _cubic_kernel(d, a=-0.75):
    d = d.abs()
    return torch.where(
        d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
        torch.where(d < 2, (((d - 5) * d + 8) * d - 4) * a,
                    torch.zeros_like(d)))


class SpecAugment(nn.Module):
    """Time warp, then frequency and time masks (``augment.py:13``).

    The warp draws a centre ``c`` in [window, T - window) and a new
    boundary ``w`` in [c - window, c + window) + 1, both on the device, and
    resizes x[:, :c] to length w and x[:, c:] to T - w with torch's bicubic
    ``align_corners=True`` interpolation (``_time_warp_cw``). Each mask
    draws (batch, n_mask) lengths in ``width_range`` and positions in [0,
    max(1, size - the largest drawn length)) (``mask_along_axis``); the
    masks of a row are OR-combined and filled with 0, or with the mean of
    the whole input when ``replace_with_zero`` is False (``_mask``). With
    no generator the module is the identity.

    Example
    -------
    >>> import torch
    >>> aug = SpecAugment(time_warp=False, freq_mask_width=(2, 4),
    ...                   time_mask_width=(2, 4))
    >>> out = aug(torch.ones(1, 50, 40), rng=torch.Generator().manual_seed(3))
    >>> out.shape, bool((out == 0).any())
    (torch.Size([1, 50, 40]), True)
    """

    def __init__(self, time_warp=True, time_warp_window=5,
                 time_warp_mode="bicubic", freq_mask=True, n_freq_mask=2,
                 time_mask=True, n_time_mask=2, replace_with_zero=True,
                 freq_mask_width=(0, 20), time_mask_width=(0, 100)):
        super().__init__()
        self.apply_time_warp = time_warp
        self.time_warp_window = time_warp_window
        self.freq_mask = freq_mask
        self.n_freq_mask = n_freq_mask
        self.time_mask = time_mask
        self.n_time_mask = n_time_mask
        self.replace_with_zero = replace_with_zero
        self.freq_mask_width = freq_mask_width
        self.time_mask_width = time_mask_width

    def forward(self, x, rng=None):
        if rng is None:
            return x
        gen = _generator(rng)
        if self.apply_time_warp:
            x = self.time_warp(x, gen)
        if self.freq_mask:
            x = self.mask_along_axis(x, gen, dim=2, n_masks=self.n_freq_mask,
                                     width_range=self.freq_mask_width)
        if self.time_mask:
            x = self.mask_along_axis(x, gen, dim=1, n_masks=self.n_time_mask,
                                     width_range=self.time_mask_width)
        return x

    def draw_warp(self, t, generator):
        """(c, w) on the generator's device, or None when T is too short."""
        window = self.time_warp_window
        if t - window <= window:
            return None
        dev = generator.device
        c = torch.randint(window, t - window, (), generator=generator,
                          device=dev)
        u = torch.rand((), generator=generator, device=dev)
        w = c - window + (u * 2 * window).long() + 1
        return c, w

    def time_warp(self, x, generator):
        drawn = self.draw_warp(x.shape[1], generator)
        if drawn is None:
            return x
        return self._time_warp_cw(x, *drawn)

    def _time_warp_cw(self, x, c, w):
        """The deterministic warp (``augment.py:84``): x[:, :c] resized to
        w frames and x[:, c:] to T - w, bicubic with ``align_corners=
        True``, the taps clamped within each segment."""
        t = x.shape[1]
        dev = x.device
        c = torch.as_tensor(c, device=dev)
        w = torch.as_tensor(w, device=dev)
        i = torch.arange(t, dtype=torch.float32, device=dev)
        cf = c.float()
        wf = w.float()
        left_src = i * (cf - 1) / torch.clamp(wf - 1, min=1)
        right_src = cf + (i - wf) * (t - cf - 1) / torch.clamp(t - wf - 1,
                                                                min=1)
        in_left = i < wf
        src = torch.where(in_left, left_src, right_src)
        lo_bound = torch.where(in_left, torch.zeros_like(c), c)
        hi_bound = torch.where(in_left, c - 1, torch.full_like(c, t - 1))
        x0 = torch.floor(src)
        out = torch.zeros_like(x)
        extra = (1,) * (x.dim() - 2)
        for k in (-1, 0, 1, 2):
            idx = torch.minimum(torch.maximum((x0 + k).long(), lo_bound),
                                hi_bound)
            wgt = _cubic_kernel(src - (x0 + k)).reshape((1, t) + extra)
            out = out + x[:, idx] * wgt.to(x.dtype)
        return out

    def draw_mask(self, b, size, n_masks, width_range, generator):
        """(positions, lengths), each (B, n_masks), on the device."""
        dev = generator.device
        mask_len = torch.randint(width_range[0], width_range[1],
                                 (b, n_masks), generator=generator,
                                 device=dev)
        bound = torch.clamp(size - mask_len.max(), min=1)
        u = torch.rand((b, n_masks), generator=generator, device=dev)
        mask_pos = (u * bound).long()
        return mask_pos, mask_len

    def mask_along_axis(self, x, generator, dim, n_masks, width_range):
        pos, length = self.draw_mask(x.shape[0], x.shape[dim], n_masks,
                                     width_range, generator)
        return self._mask(x, pos, length, dim)

    def _mask(self, x, mask_pos, mask_len, dim):
        """The deterministic masking (``augment.py:122``) for given
        (batch, n_mask) positions and lengths."""
        size = x.shape[dim]
        dev = x.device
        mask_pos = torch.as_tensor(mask_pos, device=dev)
        mask_len = torch.as_tensor(mask_len, device=dev)
        ar = torch.arange(size, device=dev)[None, None, :]
        span = ((mask_pos[:, :, None] <= ar)
                & (ar < (mask_pos + mask_len)[:, :, None])).any(dim=1)
        shape = [x.shape[0]] + [1] * (x.dim() - 1)
        shape[dim] = size
        fill = (torch.zeros((), dtype=x.dtype, device=dev)
                if self.replace_with_zero else x.mean())
        return torch.where(span.reshape(shape), fill, x)


class TimeDomainSpecAugment(nn.Module):
    """Waveform chain (``augment.py:132``): speed perturbation, then drop
    frequencies, then drop chunks, each drawing from the same generator.

    Example
    -------
    >>> import torch
    >>> aug = TimeDomainSpecAugment(speeds=[100], drop_chunk_length_low=10,
    ...                             drop_chunk_length_high=20)
    >>> aug(torch.ones(2, 800), rng=torch.Generator().manual_seed(0)).shape
    torch.Size([2, 800])
    """

    def __init__(self, perturb_prob=1.0, drop_freq_prob=1.0,
                 drop_chunk_prob=1.0, speeds=[95, 100, 105],
                 sample_rate=16000, drop_freq_count_low=0,
                 drop_freq_count_high=3, drop_chunk_count_low=0,
                 drop_chunk_count_high=5, drop_chunk_length_low=1000,
                 drop_chunk_length_high=2000, drop_chunk_noise_factor=0):
        super().__init__()
        self.speed_perturb = SpeedPerturb(
            perturb_prob=perturb_prob, orig_freq=sample_rate, speeds=speeds)
        self.drop_freq = DropFreq(
            drop_prob=drop_freq_prob, drop_count_low=drop_freq_count_low,
            drop_count_high=drop_freq_count_high)
        self.drop_chunk = DropChunk(
            drop_prob=drop_chunk_prob, drop_count_low=drop_chunk_count_low,
            drop_count_high=drop_chunk_count_high,
            drop_length_low=drop_chunk_length_low,
            drop_length_high=drop_chunk_length_high,
            noise_factor=drop_chunk_noise_factor)

    def forward(self, waveforms, lengths=None, rng=None):
        if rng is None:
            return waveforms
        waveforms = self.speed_perturb(waveforms, rng=rng)
        waveforms = self.drop_freq(waveforms, rng=rng)
        return self.drop_chunk(waveforms, lengths=lengths, rng=rng)


class EnvCorrupt(nn.Module):
    """Environmental corruption (``augment.py:167``): reverberation, then
    babble (when ``babble_speaker_count`` > 0), then noise.

    Example
    -------
    >>> import torch
    >>> env = EnvCorrupt(noise_snr_low=5, noise_snr_high=5)
    >>> env(torch.ones(2, 100), rng=torch.Generator().manual_seed(0)).shape
    torch.Size([2, 100])
    """

    def __init__(self, reverb_prob=1.0, babble_prob=1.0, noise_prob=1.0,
                 noise_snr_low=0, noise_snr_high=0, babble_speaker_count=0,
                 babble_snr_low=0, babble_snr_high=0, reverb_csv=None,
                 noise_csv=None, rir_scale_factor=1.0, pad_noise=False,
                 rir_funct=None, noise_funct=None, **unused):
        super().__init__()
        self.add_reverb = AddReverb(csv_file=reverb_csv,
                                    reverb_prob=reverb_prob,
                                    rir_scale_factor=rir_scale_factor,
                                    rir_funct=rir_funct)
        self.babble_speaker_count = babble_speaker_count
        if babble_speaker_count > 0:
            self.add_babble = AddBabble(
                mix_prob=babble_prob, speaker_count=babble_speaker_count,
                snr_low=babble_snr_low, snr_high=babble_snr_high)
        self.add_noise = AddNoise(csv_file=noise_csv, mix_prob=noise_prob,
                                  snr_low=noise_snr_low,
                                  snr_high=noise_snr_high,
                                  pad_noise=pad_noise,
                                  noise_funct=noise_funct)

    def forward(self, waveforms, lengths=None, rng=None):
        if rng is None:
            return waveforms
        waveforms = self.add_reverb(waveforms, rng=rng)
        if self.babble_speaker_count > 0:
            waveforms = self.add_babble(waveforms, lengths=lengths, rng=rng)
        return self.add_noise(waveforms, lengths=lengths, rng=rng)

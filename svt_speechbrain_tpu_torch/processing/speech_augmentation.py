"""Waveform-domain augmentation (port of
``svt_speechbrain_tpu/processing/speech_augmentation.py``).

Every random augmenter is split in two: ``draw(...)`` takes its random
values from an explicit ``torch.Generator`` (the device generator of a
``StepRNG``, or a generator given directly), on the generator's device, at
the JAX module's granularity; ``apply(..., draws)`` is a deterministic
function of the input and those values. ``forward(..., rng=None)`` is the
identity without a generator and ``apply(x, draw(...))`` with one. The
draws are not the JAX key splits' numbers, but the applies take the JAX
draws too, so the two packages compute the same function of them.

Where the JAX module reads a draw on the host (``AddNoise``'s ``mix_prob``
test, ``AddReverb``'s and ``DropFreq``'s batch gates, the corpus start
index), the port reads it too; the module's ``host_reads`` counts those
reads. The others (``SpeedPerturb``'s speed, the keep gates of
``SpeedPerturb``, ``DoClip``, ``AddBabble`` and ``DropChunk``) stay on the
device, selected by ``torch.where``/``index_select`` as the
JAX module's ``jnp.where``/``lax.switch``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from svt_speechbrain_tpu_torch.processing.signal_processing import (
    compute_amplitude, convolve1d, dB_to_amplitude, reverberate)


class _HostReads(nn.Module):
    """An augmenter that reads some of its draws on the host, as the JAX
    module does; ``host_reads`` counts those reads."""

    def __init__(self):
        super().__init__()
        self.host_reads = 0

    def _host_float(self, t):
        self.host_reads += 1
        return float(t)


def _generator(rng):
    """The generator of ``rng``: a ``StepRNG``'s device generator, or the
    ``torch.Generator`` itself."""
    return rng.device if isinstance(rng, StepRNG) else rng


def _uniform(gen, shape, low=0.0, high=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return low + u * (high - low)


def _lengths(waveforms, lengths):
    b = waveforms.shape[0]
    if lengths is None:
        return torch.ones(b, device=waveforms.device)
    return torch.as_tensor(lengths, device=waveforms.device).float()


class AddNoise(_HostReads):
    """Mix noise at a random SNR (``speech_augmentation.py:23``): one
    ``mix_prob`` draw for the batch (read on the host), an SNR per row; the
    noise is a corpus batch read from the extended CSV ``csv_file``
    (``pad_noise`` loops it, ``start_index`` or a drawn start slices it;
    amplitude-normalized to the target), ``noise_funct(generator, shape)``
    (normalized the same way), or, with neither, white noise scaled by the
    target amplitude without normalization. The corpus is read on the host
    through ``ExtendedCSVDataset`` and the loader, looping at its end; a
    "random" ``sorting`` shuffles with the loader's seeded sampler.

    ``draw(waveforms, generator)`` → {"mix": (), "snr": (B, 1), "white":
    (B, T) or None, "start_u": ()}; ``apply(waveforms, lengths, draws)``
    also takes "start" (an int, the JAX draw) in place of "start_u", whose
    start is ``int(start_u · max_chop)``.

    Example
    -------
    >>> import torch
    >>> noisy = AddNoise(snr_low=10, snr_high=10)(
    ...     torch.ones(2, 100), rng=torch.Generator().manual_seed(0))
    >>> noisy.shape, bool((noisy != 1).all())
    (torch.Size([2, 100]), True)
    """

    def __init__(self, csv_file=None, csv_keys=None, sorting="random",
                 snr_low=0, snr_high=0, pad_noise=False, mix_prob=1.0,
                 start_index=None, normalize=False, replacements={},
                 noise_funct=None):
        super().__init__()
        self.csv_file = csv_file
        self.csv_keys = csv_keys
        self.sorting = sorting
        self.snr_low = snr_low
        self.snr_high = snr_high
        self.pad_noise = pad_noise
        self.mix_prob = mix_prob
        self.start_index = start_index
        self.normalize = normalize
        self.replacements = replacements
        self.noise_funct = noise_funct
        self._noise_iter = None

    def _load_noise_batch(self):
        """The corpus's next batch as numpy (wavs (B, T), relative lens),
        looping the loader at its end (``:52``)."""
        if self._noise_iter is None:
            from svt_speechbrain_tpu_torch.dataio.dataloader import (
                make_dataloader)
            from svt_speechbrain_tpu_torch.dataio.legacy import (
                ExtendedCSVDataset)

            dataset = ExtendedCSVDataset(
                csvpath=self.csv_file, output_keys=self.csv_keys or (),
                sorting=self.sorting if self.sorting != "random"
                else "original", replacements=self.replacements)
            self._noise_loader = make_dataloader(
                dataset, batch_size=self._noise_batch_size,
                shuffle=(self.sorting == "random"))
            self._noise_iter = iter(self._noise_loader)
        try:
            batch = next(self._noise_iter)
        except StopIteration:
            self._noise_iter = iter(self._noise_loader)
            batch = next(self._noise_iter)
        wavs, lens = batch.at_position(0)
        return np.asarray(wavs), np.asarray(lens)

    def _load_noise_batch_of_size(self, batch_size):
        noise_batch, noise_lens = self._load_noise_batch()
        while len(noise_batch) < batch_size:
            added, added_lens = self._load_noise_batch()
            if added.shape[1] > noise_batch.shape[1]:
                noise_lens = noise_lens * noise_batch.shape[1] / added.shape[1]
                noise_batch = np.pad(
                    noise_batch,
                    ((0, 0), (0, added.shape[1] - noise_batch.shape[1])))
            elif noise_batch.shape[1] > added.shape[1]:
                added_lens = added_lens * added.shape[1] / noise_batch.shape[1]
                added = np.pad(
                    added, ((0, 0), (0, noise_batch.shape[1] - added.shape[1])))
            noise_batch = np.concatenate([noise_batch, added])
            noise_lens = np.concatenate([noise_lens, added_lens])
        return noise_batch[:batch_size], noise_lens[:batch_size]

    def _load_noise(self, lengths_abs, max_length, draws, device):
        """A corpus batch covering the speech (``:87``): (noise (B, T),
        its absolute lengths (B, 1)) on ``device``."""
        batch_size = len(lengths_abs)
        self._noise_batch_size = batch_size
        noise_batch, noise_rel = self._load_noise_batch_of_size(batch_size)
        # truncated (.long()), not rounded
        noise_len = (noise_rel * noise_batch.shape[1]).astype(np.int64)
        if self.pad_noise:
            while np.any(noise_len < lengths_abs):
                min_len = int(noise_len.min())
                noise_batch = np.concatenate(
                    [noise_batch[:, :min_len], noise_batch], axis=1)
                noise_len = noise_len + min_len
        elif noise_batch.shape[1] < max_length:
            noise_batch = np.pad(
                noise_batch, ((0, 0), (0, max_length - noise_batch.shape[1])))
        start_index = self.start_index
        if start_index is None:
            max_chop = max(int((noise_len - lengths_abs).min()), 1)
            if "start" in draws:
                start_index = int(draws["start"])
            else:
                start_index = min(int(self._host_float(draws["start_u"])
                                      * max_chop), max_chop - 1)
        noise_batch = noise_batch[:, start_index: start_index + max_length]
        noise_len = np.minimum(noise_len - start_index, max_length)[:, None]
        return (torch.as_tensor(noise_batch, dtype=torch.float32,
                                device=device),
                torch.as_tensor(noise_len, device=device))

    def draw(self, waveforms, generator):
        b = waveforms.shape[0]
        white = None
        if self.noise_funct is None and self.csv_file is None:
            white = torch.randn(waveforms.shape, generator=generator,
                                device=generator.device)
        return {"mix": _uniform(generator, ()),
                "snr": _uniform(generator, (b, 1), self.snr_low,
                                self.snr_high),
                "white": white, "start_u": _uniform(generator, ()),
                "generator": generator}

    def apply(self, waveforms, lengths, draws):
        t = waveforms.shape[1]
        lengths = _lengths(waveforms, lengths)
        abs_len = (lengths * t)[:, None]
        # one scalar gate for the whole batch, read on the host
        if self._host_float(draws["mix"]) > self.mix_prob:
            return waveforms
        clean_amplitude = compute_amplitude(waveforms, abs_len)
        snr = torch.as_tensor(draws["snr"], device=waveforms.device)
        factor = 1 / (dB_to_amplitude(snr) + 1)
        new_noise_amplitude = factor * clean_amplitude
        noisy = waveforms * (1 - factor)
        if self.noise_funct is not None:
            noise = torch.as_tensor(
                self.noise_funct(draws["generator"], waveforms.shape),
                device=waveforms.device)
            noise_amplitude = compute_amplitude(noise, abs_len)
            noisy = noisy + noise * (new_noise_amplitude
                                     / (noise_amplitude + 1e-14))
        elif self.csv_file is None:
            # the white-noise fallback is not normalized
            white = torch.as_tensor(draws["white"], device=waveforms.device)
            noisy = noisy + new_noise_amplitude * white
        else:
            # truncated (.long()), not rounded
            lengths_abs = (lengths.cpu().numpy() * t).astype(np.int64)
            noise_batch, noise_len = self._load_noise(
                lengths_abs, t, draws, waveforms.device)
            noise_amplitude = compute_amplitude(noise_batch, noise_len)
            noisy = noisy + noise_batch * (new_noise_amplitude
                                           / (noise_amplitude + 1e-14))
        if self.normalize:
            peak = noisy.abs().amax(dim=1, keepdim=True)
            noisy = noisy / torch.clamp(peak, min=1.0)
        return noisy

    def forward(self, waveforms, lengths=None, rng=None):
        if rng is None:
            return waveforms
        return self.apply(waveforms, lengths,
                          self.draw(waveforms, _generator(rng)))


class AddReverb(_HostReads):
    """Convolve with a room impulse response (``speech_augmentation.py:
    163``): the RIR comes from the extended CSV ``csv_file`` (read on the
    host, looping) or ``rir_funct(generator)``; ``rir_scale_factor``
    stretches it with torch's linear interpolation (``align_corners=
    False``); one ``reverb_prob`` draw gates the batch (read on the host);
    ``reverberate(..., rescale_amp="avg")``.

    ``draw(generator)`` → {"reverb": ()}; ``apply(waveforms, draws)``.
    """

    def __init__(self, csv_file=None, sorting="random", reverb_prob=1.0,
                 rir_scale_factor=1.0, replacements={}, rir_funct=None):
        super().__init__()
        self.csv_file = csv_file
        self.sorting = sorting
        self.reverb_prob = reverb_prob
        self.rir_scale_factor = rir_scale_factor
        self.replacements = replacements
        self.rir_funct = rir_funct
        self._rir_iter = None

    def _load_rir(self, device):
        """The corpus's next RIR (``:183``), looping at its end."""
        if self._rir_iter is None:
            from svt_speechbrain_tpu_torch.dataio.dataloader import (
                make_dataloader)
            from svt_speechbrain_tpu_torch.dataio.legacy import (
                ExtendedCSVDataset)

            dataset = ExtendedCSVDataset(
                csvpath=self.csv_file,
                sorting=self.sorting if self.sorting != "random"
                else "original", replacements=self.replacements)
            self._rir_loader = make_dataloader(
                dataset, shuffle=(self.sorting == "random"))
            self._rir_iter = iter(self._rir_loader)
        try:
            batch = next(self._rir_iter)
        except StopIteration:
            self._rir_iter = iter(self._rir_loader)
            batch = next(self._rir_iter)
        rir, _ = batch.at_position(0)
        return torch.as_tensor(np.asarray(rir), dtype=torch.float32,
                               device=device)

    @staticmethod
    def _interpolate_linear(rir, scale_factor):
        """torch's ``F.interpolate(mode="linear", align_corners=False)``
        along the time axis of (B, T), on the JAX module's numpy grid."""
        t_in = rir.shape[1]
        t_out = int(np.floor(t_in * scale_factor))
        pos = (np.arange(t_out) + 0.5) / scale_factor - 0.5
        pos = np.clip(pos, 0, t_in - 1)
        left = np.floor(pos).astype(np.int64)
        right = np.minimum(left + 1, t_in - 1)
        frac = torch.as_tensor(pos - left, dtype=rir.dtype, device=rir.device)
        left = torch.as_tensor(left, device=rir.device)
        right = torch.as_tensor(right, device=rir.device)
        return rir[:, left] * (1 - frac) + rir[:, right] * frac

    def draw(self, generator):
        return {"reverb": _uniform(generator, ()), "generator": generator}

    def apply(self, waveforms, draws):
        if self._host_float(draws["reverb"]) > self.reverb_prob:
            return waveforms
        if self.rir_funct is not None:
            rir = torch.as_tensor(self.rir_funct(draws["generator"]),
                                  device=waveforms.device)
        elif self.csv_file is not None:
            rir = self._load_rir(waveforms.device)
        else:
            return waveforms
        if rir.dim() == 1:
            rir = rir[None]
        if self.rir_scale_factor != 1:
            rir = self._interpolate_linear(rir, self.rir_scale_factor)
        return reverberate(waveforms, rir.to(waveforms.dtype),
                           rescale_amp="avg")

    def forward(self, waveforms, lengths=None, rng=None):
        if rng is None:
            return waveforms
        return self.apply(waveforms, self.draw(_generator(rng)))


class Resample(nn.Module):
    """Kaldi's ``LinearResample`` (``speech_augmentation.py:269``):
    raised-cosine-windowed sinc filters at the output instants, the exact
    tick-based output length and the phase/first-index layout. The weights
    (phases, taps) are built in numpy at construction, as in the JAX
    package; a call is one gather of (phase, block, tap) windows and one
    product with them. (B, T) or (B, T, C) in and out.

    Example
    -------
    >>> import torch
    >>> Resample(16000, 8000)(torch.ones(2, 160)).shape
    torch.Size([2, 80])
    """

    def __init__(self, orig_freq=16000, new_freq=16000,
                 lowpass_filter_width=6):
        super().__init__()
        self.orig_freq = int(orig_freq)
        self.new_freq = int(new_freq)
        self.lowpass_filter_width = lowpass_filter_width
        base_freq = math.gcd(self.orig_freq, self.new_freq)
        self.conv_stride = self.orig_freq // base_freq
        self.output_samples = self.new_freq // base_freq
        if self.orig_freq != self.new_freq:
            self._make_weights()

    def _make_weights(self):
        """The windowed-sinc weights (``:289``), in float64 numpy."""
        min_freq = min(self.orig_freq, self.new_freq)
        lowpass_cutoff = 0.99 * 0.5 * min_freq
        window_width = self.lowpass_filter_width / (2.0 * lowpass_cutoff)
        output_t = np.arange(self.output_samples, dtype=np.float64) \
            / self.new_freq
        min_input_index = np.ceil((output_t - window_width) * self.orig_freq)
        max_input_index = np.floor((output_t + window_width) * self.orig_freq)
        num_indices = max_input_index - min_input_index + 1
        max_weight_width = int(num_indices.max())
        j = np.arange(max_weight_width, dtype=np.float64)
        input_index = min_input_index[:, None] + j[None, :]
        delta_t = input_index / self.orig_freq - output_t[:, None]
        weights = np.zeros_like(delta_t)
        inside = np.abs(delta_t) < window_width
        weights[inside] = 0.5 * (1 + np.cos(
            2 * np.pi * lowpass_cutoff / self.lowpass_filter_width
            * delta_t[inside]))
        nonzero = delta_t != 0.0
        weights[nonzero] *= (np.sin(2 * np.pi * lowpass_cutoff
                                    * delta_t[nonzero])
                             / (np.pi * delta_t[nonzero]))
        weights[~nonzero] *= 2 * lowpass_cutoff
        weights /= self.orig_freq
        self.first_indices = min_input_index.astype(np.int64)
        self.register_buffer("weights",
                             torch.from_numpy(weights.astype(np.float32)),
                             persistent=False)          # (P, W)

    def _output_samples(self, input_num_samp):
        """The exact tick-based output length (``:324``)."""
        samp_in, samp_out = self.orig_freq, self.new_freq
        tick_freq = abs(samp_in * samp_out) // math.gcd(samp_in, samp_out)
        ticks_per_input_period = tick_freq // samp_in
        interval_length = input_num_samp * ticks_per_input_period
        if interval_length <= 0:
            return 0
        ticks_per_output_period = tick_freq // samp_out
        last_output_samp = interval_length // ticks_per_output_period
        if last_output_samp * ticks_per_output_period == interval_length:
            last_output_samp -= 1
        return last_output_samp + 1

    def forward(self, waveforms):
        if self.orig_freq == self.new_freq:
            return waveforms
        squeezed = waveforms.dim() == 2
        x = waveforms[:, :, None] if squeezed else waveforms
        b, t, c = x.shape
        p, w = self.weights.shape
        tot_output_samp = self._output_samples(t)
        n_blocks = -(-tot_output_samp // p)           # output rows a phase
        # the sample of (phase i, block n, tap j) sits at first_indices[i]
        # + n·conv_stride + j of the padded signal
        pad_left = int(max(0, -self.first_indices.min()))
        starts = (self.first_indices[:, None] + pad_left
                  + np.arange(n_blocks)[None, :] * self.conv_stride)
        idx = starts[:, :, None] + np.arange(w)[None, None, :]   # (P, N, W)
        pad_right = int(max(0, idx.max() + 1 - (t + pad_left)))
        xp = F.pad(x, (0, 0, pad_left, pad_right))
        windows = xp[:, torch.as_tensor(idx.reshape(-1), device=x.device)]
        windows = windows.reshape(b, p, n_blocks, w, c)
        out = torch.einsum("bpnwc,pw->bnpc", windows,
                           self.weights.to(x.dtype))
        out = out.reshape(b, n_blocks * p, c)[:, :tot_output_samp]
        return out[:, :, 0] if squeezed else out


class SpeedPerturb(nn.Module):
    """Speed perturbation by resampling (``speech_augmentation.py:236``):
    one of ``speeds`` (percent) for the batch, the output cut or
    zero-padded to the input length; one keep draw for the batch gates it
    against ``perturb_prob``. Both draws stay on the device: every speed's
    branch is computed and the drawn one selected (the JAX module's
    ``lax.switch``).

    ``draw(generator)`` → {"speed": () index, "keep": ()}; ``apply(
    waveform, draws)``.

    Example
    -------
    >>> import torch
    >>> sp = SpeedPerturb(16000, speeds=[90])
    >>> sp(torch.ones(2, 400), rng=torch.Generator().manual_seed(0)).shape
    torch.Size([2, 400])
    """

    def __init__(self, orig_freq, speeds=[90, 100, 110], perturb_prob=1.0):
        super().__init__()
        self.orig_freq = orig_freq
        self.speeds = speeds
        self.perturb_prob = perturb_prob
        self.resamplers = nn.ModuleList(
            Resample(orig_freq=orig_freq, new_freq=orig_freq * speed // 100)
            for speed in speeds)

    def draw(self, generator):
        return {"speed": torch.randint(0, len(self.speeds), (),
                                       generator=generator,
                                       device=generator.device),
                "keep": _uniform(generator, ())}

    def apply(self, waveform, draws):
        t = waveform.shape[1]
        branches = []
        for resampler in self.resamplers:
            out = resampler(waveform)
            if out.shape[1] >= t:
                out = out[:, :t]
            else:
                out = F.pad(out, (0, 0) * (out.dim() - 2)
                            + (0, t - out.shape[1]))
            branches.append(out)
        speed = torch.as_tensor(draws["speed"], device=waveform.device)
        perturbed = torch.index_select(torch.stack(branches), 0,
                                       speed.reshape(1).long())[0]
        keep = torch.as_tensor(draws["keep"], device=waveform.device) \
            > self.perturb_prob
        return torch.where(keep, waveform, perturbed)

    def forward(self, waveform, lengths=None, rng=None):
        if rng is None:
            return waveform
        return self.apply(waveform, self.draw(_generator(rng)))


class AddBabble(nn.Module):
    """Babble from the other rows of the batch rotated in
    (``speech_augmentation.py:363``): an SNR and a keep draw per row.

    ``draw(waveforms, generator)`` → {"snr": (B, 1), "keep": (B, 1)};
    ``apply(waveforms, lengths, draws)``.
    """

    def __init__(self, speaker_count=3, snr_low=0, snr_high=0, mix_prob=1.0):
        super().__init__()
        self.speaker_count = speaker_count
        self.snr_low = snr_low
        self.snr_high = snr_high
        self.mix_prob = mix_prob

    def draw(self, waveforms, generator):
        b = waveforms.shape[0]
        return {"snr": _uniform(generator, (b, 1), self.snr_low,
                                self.snr_high),
                "keep": _uniform(generator, (b, 1))}

    def apply(self, waveforms, lengths, draws):
        t = waveforms.shape[1]
        abs_len = (_lengths(waveforms, lengths) * t)[:, None]
        clean_amplitude = compute_amplitude(waveforms, abs_len)
        snr = torch.as_tensor(draws["snr"], device=waveforms.device)
        factor = 1 / (dB_to_amplitude(snr) + 1)
        noise_amplitude = factor * clean_amplitude
        out = waveforms * (1 - factor)
        babble = torch.roll(waveforms, 1, dims=0)
        for i in range(1, self.speaker_count):
            babble = babble + torch.roll(waveforms, 1 + i, dims=0)
        babble_amp = compute_amplitude(babble, abs_len)
        babble = babble * (noise_amplitude / (babble_amp + 1e-14))
        keep = torch.as_tensor(draws["keep"], device=waveforms.device) \
            > self.mix_prob
        return torch.where(keep, waveforms, out + babble)

    def forward(self, waveforms, lengths=None, rng=None):
        if rng is None:
            return waveforms
        return self.apply(waveforms, lengths,
                          self.draw(waveforms, _generator(rng)))


def _raw_sinc(x):
    safe = torch.where(x == 0, torch.ones_like(x), x)
    return torch.where(x == 0, torch.ones_like(x), torch.sin(x) / safe)


class DropFreq(_HostReads):
    """Random notch filters (``speech_augmentation.py:395``): one gate for
    the batch (read on the host), a notch count in [``drop_count_low``,
    ``drop_count_high``] and a frequency per possible notch; the first
    count notches are composed into one 101-tap filter on a delta, then
    applied once.

    ``draw(generator)`` → {"drop": (), "count": (), "freqs":
    (drop_count_high,)}; ``apply(waveforms, draws)``.
    """

    def __init__(self, drop_freq_low=1e-14, drop_freq_high=1,
                 drop_count_low=1, drop_count_high=2, drop_width=0.05,
                 drop_prob=1):
        super().__init__()
        self.drop_freq_low = drop_freq_low
        self.drop_freq_high = drop_freq_high
        self.drop_count_low = drop_count_low
        self.drop_count_high = drop_count_high
        self.drop_width = drop_width
        self.drop_prob = drop_prob

    def draw(self, generator):
        return {"drop": _uniform(generator, ()),
                "count": torch.randint(self.drop_count_low,
                                       self.drop_count_high + 1, (),
                                       generator=generator,
                                       device=generator.device),
                "freqs": _uniform(generator, (self.drop_count_high,),
                                  self.drop_freq_low, self.drop_freq_high)}

    def apply(self, waveforms, draws):
        if self._host_float(draws["drop"]) > self.drop_prob:
            return waveforms
        dev = waveforms.device
        dropped = waveforms[..., None] if waveforms.dim() == 2 else waveforms
        count = torch.as_tensor(draws["count"], device=dev)
        freqs = torch.as_tensor(draws["freqs"], device=dev,
                                dtype=torch.float32)
        filter_length = 101
        pad = filter_length // 2
        inputs = torch.arange(filter_length, dtype=torch.float32,
                              device=dev) - pad
        # torch.blackman_window's default: periodic
        blackman = torch.as_tensor(np.blackman(filter_length + 1)[:-1],
                                   dtype=torch.float32, device=dev)
        drop_w = self.drop_width
        delta = torch.zeros(filter_length, device=dev)
        delta[pad] = 1.0

        def notch_kernel(freq):
            freq = freq + drop_w
            lo = _raw_sinc(3 * (freq - drop_w) * inputs) * blackman
            lo = lo / lo.sum()
            hi = _raw_sinc(3 * (freq + drop_w) * inputs) * blackman
            hi = delta - hi / hi.sum()
            return (lo + hi)[None, :, None]

        drop_filter = delta[None, :, None]
        for i in range(self.drop_count_high):
            composed = convolve1d(drop_filter, notch_kernel(freqs[i]),
                                  padding=pad)
            drop_filter = torch.where(i < count, composed, drop_filter)
        out = convolve1d(dropped, drop_filter.to(dropped.dtype), padding=pad)
        return out[..., 0] if waveforms.dim() == 2 else out

    def forward(self, waveforms, rng=None):
        if rng is None:
            return waveforms
        return self.apply(waveforms, self.draw(_generator(rng)))


class DropChunk(nn.Module):
    """Zero (or fill with noise) random time chunks (``speech_augmentation.
    py:451``): a chunk count per row; for each chunk index a length and a
    start per row, the start ``drop_start + int(u · (start_max -
    drop_start))``; a keep draw per row.

    ``draw(waveforms, generator)`` → {"counts": (B,), "lengths": (K, B),
    "starts": (K, B) uniforms, "noise": (B, T) or None, "keep": (B, 1)},
    K = ``drop_count_high``; ``apply(waveforms, lengths, draws)``.

    Example
    -------
    >>> import torch
    >>> drop = DropChunk(drop_length_low=20, drop_length_high=40,
    ...                  drop_count_low=1, drop_count_high=2)
    >>> out = drop(torch.ones(1, 400), rng=torch.Generator().manual_seed(0))
    >>> bool((out == 0).any()), bool((out == 1).any())
    (True, True)
    """

    def __init__(self, drop_length_low=100, drop_length_high=1000,
                 drop_count_low=1, drop_count_high=10, drop_start=0,
                 drop_end=None, drop_prob=1, noise_factor=0.0):
        super().__init__()
        self.drop_length_low = drop_length_low
        self.drop_length_high = drop_length_high
        self.drop_count_low = drop_count_low
        self.drop_count_high = drop_count_high
        self.drop_start = drop_start
        self.drop_end = drop_end
        self.drop_prob = drop_prob
        self.noise_factor = noise_factor

    def draw(self, waveforms, generator):
        b = waveforms.shape[0]
        k = self.drop_count_high
        dev = generator.device
        noise = None
        if self.noise_factor > 0:
            noise = _uniform(generator, waveforms.shape, -1.0, 1.0)
        return {"counts": torch.randint(self.drop_count_low,
                                        self.drop_count_high + 1, (b,),
                                        generator=generator, device=dev),
                "lengths": torch.randint(self.drop_length_low,
                                         self.drop_length_high + 1, (k, b),
                                         generator=generator, device=dev),
                "starts": _uniform(generator, (k, b)),
                "noise": noise, "keep": _uniform(generator, (b, 1))}

    def apply(self, waveforms, lengths, draws):
        b, t = waveforms.shape[:2]
        dev = waveforms.device
        abs_len = _lengths(waveforms, lengths) * t
        counts = torch.as_tensor(draws["counts"], device=dev)
        drop_lengths = torch.as_tensor(draws["lengths"], device=dev).long()
        starts_u = torch.as_tensor(draws["starts"], device=dev).float()
        mask = torch.ones(b, t, dtype=waveforms.dtype, device=dev)
        ar = torch.arange(t, device=dev)[None, :]
        end = self.drop_end if self.drop_end is not None else t
        if end < 0:
            end = t + end
        for i in range(self.drop_count_high):
            length = drop_lengths[i]
            start_max = torch.clamp(end - length, min=self.drop_start + 1)
            start = (starts_u[i] * (start_max - self.drop_start)).int() \
                + self.drop_start
            span = (ar >= start[:, None]) & (ar < (start + length)[:, None])
            active = (i < counts)[:, None]
            mask = torch.where(span & active, torch.zeros_like(mask), mask)
        dropped = waveforms * mask
        if self.noise_factor > 0:
            clean_amplitude = compute_amplitude(waveforms, abs_len[:, None])
            noise = torch.as_tensor(draws["noise"], device=dev)
            noise = noise * 2 * clean_amplitude * self.noise_factor
            dropped = dropped + noise * (1 - mask)
        keep = torch.as_tensor(draws["keep"], device=dev) > self.drop_prob
        return torch.where(keep, waveforms, dropped)

    def forward(self, waveforms, lengths=None, rng=None):
        if rng is None:
            return waveforms
        return self.apply(waveforms, lengths,
                          self.draw(waveforms, _generator(rng)))


class DoClip(nn.Module):
    """Random amplitude clipping (``speech_augmentation.py:516``): one clip
    value and one keep draw for the batch, both kept on the device.

    ``draw(generator)`` → {"clip": (), "keep": ()}; ``apply(waveforms,
    draws)``.
    """

    def __init__(self, clip_low=0.5, clip_high=1, clip_prob=1):
        super().__init__()
        self.clip_low = clip_low
        self.clip_high = clip_high
        self.clip_prob = clip_prob

    def draw(self, generator):
        return {"clip": _uniform(generator, (), self.clip_low,
                                 self.clip_high),
                "keep": _uniform(generator, ())}

    def apply(self, waveforms, draws):
        clip = torch.as_tensor(draws["clip"], device=waveforms.device,
                               dtype=waveforms.dtype)
        clipped = torch.minimum(torch.maximum(waveforms, -clip), clip)
        keep = torch.as_tensor(draws["keep"], device=waveforms.device) \
            > self.clip_prob
        return torch.where(keep, waveforms, clipped)

    def forward(self, waveforms, rng=None):
        if rng is None:
            return waveforms
        return self.apply(waveforms, self.draw(_generator(rng)))

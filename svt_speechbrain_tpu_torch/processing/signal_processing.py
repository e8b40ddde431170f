"""Low-level signal processing (port of
``svt_speechbrain_tpu/processing/signal_processing.py``).

Every function takes torch tensors and computes on their device; a caller
that holds numpy arrays moves them with ``torch.as_tensor(x, device=...)``
first (``notch_filter``, which takes no tensor, is given its ``device``).
The SNR mixing pair ``compute_amplitude``/``dB_to_amplitude`` drives the
noise synthesis of ``recipes/N20EMv2/audio_visual/synthesis_noise.py``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# numpy's pad modes (the JAX package's ``jnp.pad``) → torch's
_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "edge": "replicate", "wrap": "circular"}


def compute_amplitude(waveforms, lengths=None, amp_type="avg", scale="linear"):
    """Average or peak amplitude per waveform (``signal_processing.py:16``).

    waveforms: [time], [batch, time] or [batch, time, channels]; returns
    [batch, 1(, channels)]. ``lengths`` divides the sum of an "avg"
    amplitude (a number or a tensor broadcastable to the result).

    Example
    -------
    >>> wav = torch.tensor([[0.5, -0.5, 0.5, -0.5]])
    >>> float(compute_amplitude(wav)[0, 0])
    0.5
    >>> round(float(compute_amplitude(wav, scale="dB")[0, 0]), 2)
    -6.02
    """
    if waveforms.dim() == 1:
        waveforms = waveforms[None]
    assert amp_type in ("avg", "peak")
    assert scale in ("linear", "dB")
    if amp_type == "avg":
        if lengths is None:
            out = waveforms.abs().mean(dim=1, keepdim=True)
        else:
            out = waveforms.abs().sum(dim=1, keepdim=True) / lengths
    else:
        out = waveforms.abs().amax(dim=1, keepdim=True)
    if scale == "dB":
        out = torch.clamp(20 * torch.log10(torch.clamp(out, min=1e-14)),
                          min=-80)
    return out


def dB_to_amplitude(SNR):
    """10^(SNR/20) (``signal_processing.py:51``), of a number or a tensor."""
    return 10 ** (SNR / 20)


def normalize(waveforms, lengths=None, amp_type="avg", eps=1e-14):
    """Divide by the average or peak amplitude (``signal_processing.py:56``)."""
    assert amp_type in ("avg", "peak")
    den = compute_amplitude(waveforms, lengths, amp_type) + eps
    if waveforms.dim() == 1:
        return waveforms / den[0]
    return waveforms / den


def rescale(waveforms, lengths, target_lvl, amp_type="avg", scale="linear"):
    """Normalize, then scale to ``target_lvl`` (linear, or in dB)
    (``signal_processing.py:65``)."""
    assert amp_type in ("peak", "avg")
    assert scale in ("linear", "dB")
    batch_added = waveforms.dim() == 1
    if batch_added:
        waveforms = waveforms[None]
    out = normalize(waveforms, lengths, amp_type)
    out = (target_lvl if scale == "linear" else dB_to_amplitude(target_lvl)) \
        * out
    return out[0] if batch_added else out


def convolve1d(waveform, kernel, padding=0, pad_type="constant", stride=1,
               groups=1, use_fft=False, rotation_index=0):
    """1-D convolution of (batch, time, channels) with a kernel
    (out, width, in/groups) (``signal_processing.py:84``). A ``(left,
    right)`` ``padding`` pads with ``pad_type`` (numpy's mode names) first;
    an int pads zeros on both sides. ``use_fft`` convolves circularly with
    the kernel rotated by ``rotation_index`` (the reverberation path)."""
    if isinstance(padding, (tuple, list)):
        mode = _PAD_MODES[pad_type]
        padded = F.pad(waveform.transpose(1, 2), tuple(padding), mode=mode)
        waveform = padded.transpose(1, 2)
        padding = 0

    if use_fft:
        zero_length = waveform.shape[1] - kernel.shape[1]
        if zero_length < 0:
            kernel = kernel[:, :waveform.shape[1]]
            zero_length = 0
        zeros = torch.zeros(kernel.shape[0], zero_length, kernel.shape[2],
                            dtype=kernel.dtype, device=kernel.device)
        kernel = torch.cat([kernel[:, rotation_index:], zeros,
                            kernel[:, :rotation_index]], dim=1)
        return torch.fft.irfft(
            torch.fft.rfft(waveform, dim=1) * torch.fft.rfft(kernel, dim=1),
            n=waveform.shape[1], dim=1)

    out = F.conv1d(waveform.transpose(1, 2), kernel.permute(0, 2, 1),
                   stride=stride, padding=padding, groups=groups)
    return out.transpose(1, 2)


def reverberate(waveforms, rir_waveform, rescale_amp="avg"):
    """Convolve speech with a room impulse response, keeping its amplitude
    (``signal_processing.py:120``)."""
    orig_shape = waveforms.shape
    if waveforms.dim() == 1:
        waveforms = waveforms[None, :, None]
    elif waveforms.dim() == 2:
        waveforms = waveforms[..., None]
    if rir_waveform.dim() == 1:
        rir_waveform = rir_waveform[None, :, None]
    elif rir_waveform.dim() == 2:
        rir_waveform = rir_waveform[..., None]

    orig_amplitude = compute_amplitude(waveforms, waveforms.shape[1],
                                       rescale_amp)
    value_max = int(rir_waveform.abs().argmax(dim=1)[0, 0])
    waveforms = convolve1d(waveforms, rir_waveform, use_fft=True,
                           rotation_index=value_max)
    waveforms = rescale(waveforms, waveforms.shape[1], orig_amplitude,
                        rescale_amp)
    return waveforms.reshape(orig_shape)


def notch_filter(notch_freq, filter_width=101, notch_width=0.05, device=None):
    """FIR band-rejection kernel (1, width, 1), float32, on ``device``
    (``signal_processing.py:142``): ``sin(x)/x`` at ``3·f·n``, the periodic
    Blackman window, a low-pass plus a spectrally inverted high-pass."""
    assert 0 < notch_freq <= 1
    assert filter_width % 2 != 0
    pad = filter_width // 2
    inputs = (np.arange(filter_width) - pad).astype(np.float64)
    notch_freq += notch_width

    def sinc(x):
        out = np.ones_like(x)
        nz = x != 0
        out[nz] = np.sin(x[nz]) / x[nz]
        return out

    blackman = np.blackman(filter_width + 1)[:-1]   # periodic window
    hlpf = sinc(3 * (notch_freq - notch_width) * inputs) * blackman
    hlpf /= hlpf.sum()
    hhpf = sinc(3 * (notch_freq + notch_width) * inputs) * blackman
    hhpf /= -hhpf.sum()
    hhpf[pad] += 1
    return torch.tensor((hlpf + hhpf)[None, :, None], dtype=torch.float32,
                        device=device)


def overlap_and_add(signal, frame_step):
    """Reconstruct a signal from frames (``signal_processing.py:170``):
    (..., frames, frame_length) → (..., frame_step·(frames−1) +
    frame_length)."""
    outer = signal.shape[:-2]
    frames, frame_length = signal.shape[-2:]
    subframe_length = math.gcd(frame_length, frame_step)
    subframe_step = frame_step // subframe_length
    subframes_per_frame = frame_length // subframe_length
    output_size = frame_step * (frames - 1) + frame_length
    output_subframes = output_size // subframe_length

    subframe_signal = signal.reshape(*outer, -1, subframe_length)
    frame_idx = torch.arange(frames, device=signal.device) * subframe_step
    idx = (frame_idx[:, None] + torch.arange(
        subframes_per_frame, device=signal.device)[None, :]).reshape(-1)
    result = torch.zeros(*outer, output_subframes, subframe_length,
                         dtype=signal.dtype, device=signal.device)
    result.index_add_(len(outer), idx, subframe_signal)
    return result.reshape(*outer, -1)


def mix_at_snr(clean, noise, snr_db, eps=1e-14):
    """Mix ``noise`` into ``clean`` at ``snr_db`` with the amplitude-factor
    formula of ``signal_processing.py:193``:

    ``factor = 1 / (dB_to_amplitude(snr) + 1)``;
    ``out = clean * (1 - factor) + noise * factor * amp(clean) / amp(noise)``.

    Example
    -------
    >>> clean, noise = torch.ones(4), torch.tensor([1.0, -1.0, 1.0, -1.0])
    >>> mix_at_snr(clean, noise, 0).tolist()
    [1.0, 0.0, 1.0, 0.0]
    """
    clean_amplitude = compute_amplitude(clean)
    noise_amplitude_factor = 1 / (dB_to_amplitude(snr_db) + 1)
    new_noise_amplitude = noise_amplitude_factor * clean_amplitude
    sig = clean * (1 - noise_amplitude_factor)
    noise_amplitude = compute_amplitude(noise)
    noise = noise * (new_noise_amplitude / (noise_amplitude + eps))
    if sig.dim() == 1:
        return sig + noise[0] if noise.dim() > 1 else sig + noise
    return sig + noise


def resynthesize(enhanced_mag, noisy_inputs, stft, istft, normalize_wavs=True):
    """Waveforms from enhanced magnitudes and the noisy phase
    (``signal_processing.py:213``): ``stft(noisy_inputs)`` gives (..., 2)
    real/imaginary pairs, the magnitude takes their phase, and
    ``istft(complex, sig_length=...)`` returns the waveforms, peak
    normalized unless ``normalize_wavs`` is False. The JAX package calls
    its callables with a leading ``params`` argument; the port's take
    none."""
    noisy_feats = stft(noisy_inputs)
    phase = torch.atan2(noisy_feats[..., 1], noisy_feats[..., 0])
    complex_pred = enhanced_mag[..., None] * torch.stack(
        [torch.cos(phase), torch.sin(phase)], dim=-1)
    pred_wavs = istft(complex_pred, sig_length=noisy_inputs.shape[1])
    if normalize_wavs:
        pred_wavs = normalize(pred_wavs, amp_type="peak")
    return pred_wavs

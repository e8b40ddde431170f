"""Speech features (port of ``svt_speechbrain_tpu/processing/features.py``):
windows, STFT and its inverse, magnitudes, the mel filterbank, the DCT,
deltas, context windows and input normalization. The modules hold no
parameters; their constant tables (windows, filter and DCT matrices) are
non-persistent buffers that follow the module to its device. The JAX
package computes these outside any kernel; here the FFTs are
``torch.fft`` (cuFFT on the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def hamming_window(n):
    """Periodic Hamming window of ``n`` points (``features.py:21``).

    Example
    -------
    >>> [round(v, 2) for v in hamming_window(4).tolist()]
    [0.08, 0.54, 1.0, 0.54]
    """
    if n <= 1:
        return torch.ones(n)
    return torch.from_numpy(np.hamming(n + 1)[:-1].astype(np.float32))


def hann_window(n):
    """Periodic Hann window of ``n`` points (``features.py:28``)."""
    if n <= 1:
        return torch.ones(n)
    return torch.from_numpy(np.hanning(n + 1)[:-1].astype(np.float32))


class STFT(nn.Module):
    """Short-term Fourier transform (``features.py:35``): (batch, time) or
    (batch, time, channels) → (batch, frames, n_fft//2+1, 2[, channels]),
    real and imaginary parts on the axis after the bins. With ``center``
    the signal is padded by n_fft//2 on each side ("constant" or
    "reflect"); frames of n_fft every hop, the window centred in n_fft.

    Example
    -------
    >>> import torch
    >>> stft = STFT(sample_rate=16000, win_length=25, hop_length=10,
    ...             n_fft=400)
    >>> stft(torch.zeros(2, 16000)).shape           # 1 s -> 101 frames
    torch.Size([2, 101, 201, 2])
    """

    def __init__(self, sample_rate, win_length=25, hop_length=10, n_fft=400,
                 window_fn=hamming_window, normalized_stft=False, center=True,
                 pad_mode="constant", onesided=True):
        super().__init__()
        self.sample_rate = sample_rate
        self.win_length = int(round((sample_rate / 1000.0) * win_length))
        self.hop_length = int(round((sample_rate / 1000.0) * hop_length))
        self.n_fft = n_fft
        self.normalized_stft = normalized_stft
        self.center = center
        self.pad_mode = pad_mode
        self.onesided = onesided
        win = window_fn(self.win_length)
        if self.win_length < n_fft:
            lpad = (n_fft - self.win_length) // 2
            win = F.pad(win, (lpad, n_fft - self.win_length - lpad))
        self.register_buffer("window", win, persistent=False)

    def forward(self, x):
        multi_channel = x.dim() == 3
        if multi_channel:
            b, t, c = x.shape
            x = x.transpose(1, 2).reshape(b * c, t)
        if self.center:
            pad = self.n_fft // 2
            x = F.pad(x[:, None], (pad, pad), mode=self.pad_mode)[:, 0]
        frames = x.unfold(1, self.n_fft, self.hop_length) * self.window
        spec = (torch.fft.rfft(frames, n=self.n_fft, dim=-1) if self.onesided
                else torch.fft.fft(frames, n=self.n_fft, dim=-1))
        if self.normalized_stft:
            spec = spec / math.sqrt(self.n_fft)
        out = torch.stack([spec.real, spec.imag], dim=-1)
        if multi_channel:
            out = out.reshape(b, c, *out.shape[1:]).permute(0, 2, 3, 4, 1)
        return out


class ISTFT(nn.Module):
    """Inverse STFT (``features.py:95``): the inverse real FFT of each
    frame's (bins, 2), the first win_length samples times the window,
    overlap-added and divided by the overlap-added squared window (at least
    ``epsilon``); with ``center`` the first n_fft//2 samples dropped, and
    cut to ``sig_length`` when given.

    Example
    -------
    >>> import torch
    >>> x = torch.randn(1, 1600, generator=torch.Generator().manual_seed(0))
    >>> spec = STFT(16000, n_fft=400)(x)
    >>> y = ISTFT(16000, n_fft=400)(spec, sig_length=1600)
    >>> float((y[:, 200:1400] - x[:, 200:1400]).abs().max()) < 1e-4
    True
    """

    def __init__(self, sample_rate, win_length=25, hop_length=10, n_fft=None,
                 window_fn=hamming_window, center=True, onesided=True,
                 epsilon=1e-12):
        super().__init__()
        self.sample_rate = sample_rate
        self.win_length = int(round((sample_rate / 1000.0) * win_length))
        self.hop_length = int(round((sample_rate / 1000.0) * hop_length))
        self.n_fft = n_fft or self.win_length
        self.center = center
        self.onesided = onesided
        self.epsilon = epsilon
        self.register_buffer("window", window_fn(self.win_length),
                             persistent=False)

    def forward(self, x, sig_length=None):
        comp = torch.complex(x[..., 0], x[..., 1])
        frames = torch.fft.irfft(comp, n=self.n_fft, dim=-1)
        frames = frames[..., :self.win_length] * self.window
        b, n_frames, w = frames.shape
        out_len = self.hop_length * (n_frames - 1) + w
        idx = (self.hop_length * torch.arange(n_frames, device=x.device)
               [:, None] + torch.arange(w, device=x.device)[None, :])
        idx = idx.reshape(-1)
        sig = frames.new_zeros(b, out_len).index_add(
            1, idx, frames.reshape(b, -1))
        norm = frames.new_zeros(out_len).index_add(
            0, idx, self.window.square().repeat(n_frames))
        sig = sig / torch.clamp(norm, min=self.epsilon)
        if self.center:
            sig = sig[:, self.n_fft // 2:]
        if sig_length is not None:
            sig = sig[:, :sig_length]
        return sig


def spectral_magnitude(stft, power=1, log=False, eps=1e-14):
    """|X|^(2·power) from a real/imaginary stack (``features.py:135``),
    its log (plus ``eps``) with ``log``.

    Example
    -------
    >>> import torch
    >>> spectral_magnitude(torch.tensor([[3.0, 4.0]]), power=0.5).tolist()
    [5.0]
    """
    spectr = stft[..., 0] ** 2 + stft[..., 1] ** 2
    if power < 1:
        spectr = spectr + 1e-30
    spectr = spectr ** power
    if log:
        return torch.log(spectr + eps)
    return spectr


class Filterbank(nn.Module):
    """Mel filterbank over power spectrograms (``features.py:146``):
    (batch, frames, n_fft//2+1[, channels]) → (batch, frames, n_mels[,
    channels]); triangular, rectangular or gaussian filters between f_min
    and f_max, then, with ``log_mel``, 10·log10 (20· for a magnitude
    spectrogram) clamped at ``amin`` and to ``top_db`` below each
    utterance's maximum.

    Example
    -------
    >>> import torch
    >>> Filterbank(n_mels=40)(torch.ones(2, 101, 201)).shape
    torch.Size([2, 101, 40])
    """

    def __init__(self, n_mels=40, log_mel=True, filter_shape="triangular",
                 f_min=0, f_max=8000, n_fft=400, sample_rate=16000,
                 power_spectrogram=2, amin=1e-10, ref_value=1.0, top_db=80.0,
                 freeze=True, param_change_factor=1.0, param_rand_factor=0.0):
        super().__init__()
        self.n_mels = n_mels
        self.log_mel = log_mel
        self.filter_shape = filter_shape
        self.n_fft = n_fft
        self.sample_rate = sample_rate
        self.amin = amin
        self.top_db = top_db
        self.freeze = freeze
        self.n_stft = n_fft // 2 + 1
        self.db_multiplier = math.log10(max(amin, ref_value))
        self.multiplier = 10 if power_spectrogram == 2 else 20
        to_mel = 2595 * np.log10(1 + np.asarray([f_min, f_max]) / 700)
        mel = np.linspace(to_mel[0], to_mel[1], n_mels + 2)
        hz = 700 * (10 ** (mel / 2595) - 1)
        band = (hz[1:-1] - hz[:-2])[None, :]
        f_central = hz[1:-1][None, :]
        freqs = np.linspace(0, sample_rate // 2, self.n_stft)[:, None]
        if filter_shape == "triangular":
            slope = (freqs - f_central) / band
            fbank = np.maximum(0, np.minimum(slope + 1.0, -slope + 1.0))
        elif filter_shape == "rectangular":
            fbank = ((freqs > f_central - band)
                     * (freqs < f_central + band)).astype(np.float32)
        else:
            fbank = np.exp(-0.5 * ((freqs - f_central) / (band / 2)) ** 2)
        self.register_buffer("fbank", torch.from_numpy(
            fbank.astype(np.float32)), persistent=False)

    def forward(self, spectrogram):
        multi_channel = spectrogram.dim() == 4
        if multi_channel:
            b, t, f, c = spectrogram.shape
            spectrogram = spectrogram.permute(0, 3, 1, 2).reshape(b * c, t, f)
        fbanks = spectrogram @ self.fbank.to(spectrogram.dtype)
        if self.log_mel:
            fbanks = self._amplitude_to_DB(fbanks)
        if multi_channel:
            fbanks = fbanks.reshape(b, c, t, -1).permute(0, 2, 3, 1)
        return fbanks

    def _amplitude_to_DB(self, x):
        x_db = self.multiplier * torch.log10(torch.clamp(x, min=self.amin))
        x_db = x_db - self.multiplier * self.db_multiplier
        floor = x_db.amax(dim=(-2, -1), keepdim=True) - self.top_db
        return torch.maximum(x_db, floor)


class DCT(nn.Module):
    """Discrete cosine transform of the last axis (``features.py:224``),
    orthonormal or scaled by 2, to ``n_out`` coefficients.

    Example
    -------
    >>> import torch
    >>> DCT(input_size=40, n_out=20)(torch.ones(2, 5, 40)).shape
    torch.Size([2, 5, 20])
    """

    def __init__(self, input_size, n_out=20, ortho_norm=True):
        super().__init__()
        if n_out > input_size:
            raise ValueError("n_out must be <= input size")
        n = np.arange(float(input_size))
        k = np.arange(float(n_out))
        dct = np.cos(np.pi / input_size * (n[:, None] + 0.5) * k[None, :])
        if ortho_norm:
            dct[:, 0] *= 1.0 / np.sqrt(2)
            dct *= np.sqrt(2.0 / input_size)
        else:
            dct *= 2.0
        self.register_buffer("dct_mat", torch.from_numpy(
            dct.astype(np.float32)), persistent=False)

    def forward(self, x):
        multi_channel = x.dim() == 4
        if multi_channel:
            b, t, f, c = x.shape
            x = x.permute(0, 3, 1, 2).reshape(b * c, t, f)
        out = x @ self.dct_mat.to(x.dtype)
        if multi_channel:
            out = out.reshape(b, c, t, -1).permute(0, 2, 3, 1)
        return out


class Deltas(nn.Module):
    """Delta coefficients along time (``features.py:252``): for a window of
    2n+1 frames, Σ_m m·x[t+m] / (n(n+1)(2n+1)/3), the edges repeated.

    Example
    -------
    >>> import torch
    >>> x = torch.arange(6.0)[None, :, None]
    >>> Deltas(input_size=1)(x)[0, :, 0].tolist()
    [0.5, 0.800000011920929, 1.0, 1.0, 0.800000011920929, 0.5]
    """

    def __init__(self, input_size, window_length=5):
        super().__init__()
        self.n = (window_length - 1) // 2
        self.denom = self.n * (self.n + 1) * (2 * self.n + 1) / 3
        self.register_buffer(
            "kernel", torch.arange(-self.n, self.n + 1,
                                   dtype=torch.float32)[None, None],
            persistent=False)

    def forward(self, x):
        orig_dim = x.dim()
        if orig_dim == 4:
            b, t, f, c = x.shape
            x = x.permute(0, 3, 1, 2).reshape(b * c, t, f)
        rows = x.transpose(1, 2).reshape(-1, 1, x.shape[1])
        rows = F.pad(rows, (self.n, self.n), mode="replicate")
        out = F.conv1d(rows, self.kernel.to(x.dtype))
        out = out.reshape(x.shape[0], x.shape[2], -1).transpose(1, 2)
        out = out / self.denom
        if orig_dim == 4:
            out = out.reshape(b, c, t, f).permute(0, 2, 3, 1)
        return out


class ContextWindow(nn.Module):
    """Frame splicing (``features.py:281``): each frame with
    ``left_frames`` before and ``right_frames`` after it, zeros outside the
    sequence; the copies of input feature f are consecutive output
    features, ``out[..., f·CL + j] = x[t + j - left]``.

    Example
    -------
    >>> import torch
    >>> x = torch.arange(3.0)[None, :, None]
    >>> ContextWindow(1, 1)(x)[0].tolist()
    [[0.0, 0.0, 1.0], [0.0, 1.0, 2.0], [1.0, 2.0, 0.0]]
    """

    def __init__(self, left_frames=0, right_frames=0):
        super().__init__()
        self.left_frames = left_frames
        self.right_frames = right_frames

    def forward(self, x):
        orig_dim = x.dim()
        if orig_dim == 4:
            b, t, f, c = x.shape
            x = x.permute(0, 3, 1, 2).reshape(b * c, t, f)
        t = x.shape[1]
        pad = max(self.left_frames, self.right_frames)
        xp = F.pad(x, (0, 0, pad, pad))
        pieces = [xp[:, pad + j - self.left_frames:
                     pad + j - self.left_frames + t]
                  for j in range(self.left_frames + self.right_frames + 1)]
        out = torch.stack(pieces, dim=-1).reshape(x.shape[0], t, -1)
        if orig_dim == 4:
            out = out.reshape(b, c, t, -1).permute(0, 2, 3, 1)
        return out


class InputNormalization(nn.Module):
    """Mean and variance normalization, by "sentence", "batch", "speaker"
    or "global" statistics (``features.py:314``).

    Each sentence's statistics run over its first round(length · T) frames
    (at least 1): the mean and the unbiased std, clamped at 1e-10, one per
    feature. "batch" averages them over the batch. "global" keeps a running
    average in the buffers ``glob_mean``, ``glob_std`` and ``count``: the
    first training batch sets it, later ones update it with weight
    1/(count+1) (or ``avg_factor``) while ``epoch`` < ``update_until_epoch``,
    and ``count`` grows with every training batch; evaluation normalizes
    with it. The buffers start as scalars (0, 1, 0) and take the feature
    shape at the first training batch; they go into the state dict, and a
    state dict of either shape loads. "speaker" keeps per-speaker running
    statistics in host dictionaries, carried in the module's extra state.

    ``forward(x, lengths=None, spk_ids=None, epoch=0, train=True)`` → the
    normalized x; the JAX module's default ``train=True`` is kept.

    Example
    -------
    >>> import torch
    >>> norm = InputNormalization()
    >>> x = torch.arange(12.0).reshape(2, 3, 2)
    >>> y = norm(x, torch.ones(2))
    >>> norm.glob_mean.tolist(), int(norm.count)
    ([5.0, 6.0], 1)
    """

    def __init__(self, mean_norm=True, std_norm=True, norm_type="global",
                 avg_factor=None, requires_grad=False, update_until_epoch=3):
        super().__init__()
        self.mean_norm = mean_norm
        self.std_norm = std_norm
        self.norm_type = norm_type
        self.avg_factor = avg_factor
        self.update_until_epoch = update_until_epoch
        self.eps = 1e-10
        self.register_buffer("glob_mean", torch.zeros(()))
        self.register_buffer("glob_std", torch.ones(()))
        self.register_buffer("count", torch.zeros(()))
        self.spk_dict_mean, self.spk_dict_std, self.spk_dict_count = {}, {}, {}

    def get_extra_state(self):
        return {"spk_dict_mean": self.spk_dict_mean,
                "spk_dict_std": self.spk_dict_std,
                "spk_dict_count": self.spk_dict_count}

    def set_extra_state(self, state):
        self.spk_dict_mean = dict(state["spk_dict_mean"])
        self.spk_dict_std = dict(state["spk_dict_std"])
        self.spk_dict_count = dict(state["spk_dict_count"])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the running statistics take the shape of what is loaded
        for name in ("glob_mean", "glob_std", "count"):
            value = state_dict.get(prefix + name)
            if value is not None and value.shape != self._buffers[name].shape:
                self._buffers[name] = self._buffers[name].new_empty(
                    value.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _current_stats(self, x, lengths):
        t = x.shape[1]
        n = torch.clamp(torch.round(lengths * t), 1, t)
        mask = (torch.arange(t, device=x.device)[None, :]
                < n[:, None]).to(x.dtype)
        while mask.dim() < x.dim():
            mask = mask[..., None]
        denom = mask.sum(dim=1, keepdim=True)
        mean = (x * mask).sum(dim=1, keepdim=True) / denom
        var = (((x - mean) * mask).square().sum(dim=1, keepdim=True)
               / torch.clamp(denom - 1.0, min=1.0))
        cur_mean = mean[:, 0] if self.mean_norm else torch.zeros_like(
            mean[:, 0])
        cur_std = var.sqrt()[:, 0] if self.std_norm else torch.ones_like(
            mean[:, 0])
        return cur_mean, torch.clamp(cur_std, min=self.eps)

    def _speaker(self, x, cur_mean, cur_std, spk_ids, train):
        cm, cs = cur_mean.detach().cpu().numpy(), cur_std.detach().cpu().numpy()
        xs = x.detach().cpu().numpy()
        rows = []
        for i in range(x.shape[0]):
            spk = int(np.asarray(spk_ids[i]).reshape(-1)[0])
            if train:
                if spk not in self.spk_dict_mean:
                    self.spk_dict_mean[spk] = cm[i]
                    self.spk_dict_std[spk] = cs[i]
                    self.spk_dict_count[spk] = 1
                else:
                    self.spk_dict_count[spk] += 1
                    w = (1 / self.spk_dict_count[spk]
                         if self.avg_factor is None else self.avg_factor)
                    self.spk_dict_mean[spk] = ((1 - w) * self.spk_dict_mean[spk]
                                               + w * cm[i])
                    self.spk_dict_std[spk] = ((1 - w) * self.spk_dict_std[spk]
                                              + w * cs[i])
                m, s = self.spk_dict_mean[spk], self.spk_dict_std[spk]
            elif spk in self.spk_dict_mean:
                m, s = self.spk_dict_mean[spk], self.spk_dict_std[spk]
            else:
                m, s = cm[i], cs[i]
            rows.append((xs[i] - m) / s)
        return torch.from_numpy(np.stack(rows)).to(x.device, x.dtype)

    def forward(self, x, lengths=None, spk_ids=None, epoch=0, train=True):
        if lengths is None:
            lengths = torch.ones(x.shape[0], device=x.device)
        lengths = torch.as_tensor(lengths, device=x.device).to(x.dtype)
        cur_mean, cur_std = self._current_stats(x, lengths)
        if self.norm_type == "sentence":
            return (x - cur_mean[:, None]) / cur_std[:, None]
        if self.norm_type == "speaker":
            return self._speaker(x, cur_mean, cur_std, spk_ids, train)
        current_mean = cur_mean.mean(dim=0)
        current_std = cur_std.mean(dim=0)
        if self.norm_type == "batch":
            return (x - current_mean) / current_std
        if train:
            with torch.no_grad():
                count = self.count
                w = (1.0 / (count + 1.0) if self.avg_factor is None
                     else self.avg_factor)
                if epoch < self.update_until_epoch:
                    mean = (1 - w) * self.glob_mean + w * current_mean
                    std = (1 - w) * self.glob_std + w * current_std
                else:
                    mean = self.glob_mean * torch.ones_like(current_mean)
                    std = self.glob_std * torch.ones_like(current_std)
                first = count == 0
                self._buffers["glob_mean"] = torch.where(
                    first, current_mean.detach(), mean)
                self._buffers["glob_std"] = torch.where(
                    first, current_std.detach(), std)
                self._buffers["count"] = count + 1.0
        return (x - self.glob_mean) / self.glob_std

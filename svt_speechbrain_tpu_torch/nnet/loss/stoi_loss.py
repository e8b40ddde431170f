"""Negative-STOI training loss (port of
``svt_speechbrain_tpu/nnet/loss/stoi_loss.py``): each utterance cut to its
relative length, resampled 16 kHz → 10 kHz by the port's Kaldi
``Resample``, its silent frames removed (the interleaved non-overlapping
frame split of the reference), a centred reflect-padded power spectrogram,
FFT-bin-snapped one-third-octave bands, 30-frame envelope segments with
scale and (1+c)·X clipping, and the normalized-correlation sum d / (J·M).

The loss runs per utterance, as the reference's Python loop: the shapes
after silent-frame removal depend on the data (the frame mask is read on
the host), but every operation on the signal is a differentiable torch
operation on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from svt_speechbrain_tpu_torch.processing.speech_augmentation import Resample

# np.finfo("float").eps, the reference's smallVal
_SMALL = float(np.finfo("float").eps)


def thirdoct(fs, nfft, num_bands, min_freq):
    """The one-third-octave band matrix (num_bands, nfft//2+1) with edges
    snapped to the nearest FFT bin, each band covering [fl_bin, fh_bin),
    and the band centres (``stoi_loss.py:32``); numpy.

    Example
    -------
    >>> obm, cf = thirdoct(10000, 512, 15, 150)
    >>> obm.shape, int(obm[0].sum()) > 0
    ((15, 257), True)
    """
    f = np.linspace(0, fs, nfft + 1)[: int(nfft / 2) + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = (2.0 ** (1.0 / 3)) ** k * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)), np.float32)
    for i in range(num_bands):
        fl_ii = int(np.argmin(np.square(f - freq_low[i])))
        fh_ii = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl_ii:fh_ii] = 1.0
    return obm, cf


def removeSilentFrames(x, y, dyn_range=40, N=256, K=128):
    """Drop the 256-sample frames of ``x`` more than ``dyn_range`` dB below
    its loudest, keeping ``y`` aligned, and overlap-add the kept frames
    (``stoi_loss.py:58``). The frames interleave two non-overlapping splits
    (offsets 0 and 128), and the overlap-add uses the window once, as in
    the reference.

    Example
    -------
    >>> import torch
    >>> x = torch.cat([torch.zeros(512), torch.ones(1024), torch.zeros(512)])
    >>> xs, ys = removeSilentFrames(x, x.clone())
    >>> len(xs) < len(x)
    True
    """
    x = torch.as_tensor(x).float()
    y = torch.as_tensor(y, device=x.device).float()
    w = torch.as_tensor(np.hanning(256), dtype=torch.float32, device=x.device)
    n = int(x.shape[0])

    def interleave(v):
        v1 = v[0: n // N * N].reshape(n // N, N)
        v2 = v[K: (n - K) // N * N + K].reshape((n - K) // N, N)
        out = v.new_zeros(v1.shape[0] + v2.shape[0], N)
        out[0::2] = v1
        out[1::2] = v2
        return out                                         # frames x N

    X = interleave(x)
    Y = interleave(y)
    energy = 20 * torch.log10(
        torch.sqrt((w ** 2) @ (X.T ** 2)) / 16.0 + _SMALL)
    keep = torch.nonzero(energy - energy.max() + dyn_range > 0)[:, 0]

    x_sil = (X[keep] * w[None, :]).T                       # (N, kept)
    y_sil = (Y[keep] * w[None, :]).T

    def ola(v):
        return torch.cat([v[0:K, 0],
                          (v[0:K, 1:] + v[K:, 0:-1]).T.flatten(),
                          v[K:N, -1]], dim=0)

    return ola(x_sil), ola(y_sil)


def _spectrogram_pow2(x, n_fft=512, win_length=256, hop_length=128):
    """torchaudio's ``Spectrogram(n_fft=512, win_length=256,
    hop_length=128, power=2)``: reflect-padded by n_fft//2, a periodic
    Hann of ``win_length`` centred in n_fft, |rfft|². (n_fft//2+1,
    frames)."""
    pad = n_fft // 2
    xp = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    n_frames = 1 + (xp.shape[0] - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    win = np.zeros(n_fft, np.float32)
    half = (n_fft - win_length) // 2
    win[half: half + win_length] = np.hanning(win_length + 1)[:-1]
    frames = xp[torch.as_tensor(idx, device=x.device)] \
        * torch.as_tensor(win, device=x.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return (spec.abs() ** 2).T


_RESAMPLERS = {}


def _resample_1d(x, orig_freq, new_freq):
    key = (orig_freq, new_freq)
    if key not in _RESAMPLERS:
        _RESAMPLERS[key] = Resample(orig_freq=orig_freq, new_freq=new_freq)
    resampler = _RESAMPLERS[key].to(x.device)
    return resampler(x.float()[None])[0]


def stoi_loss(y_pred_batch, y_true_batch, lens=None, reduction="mean"):
    """Negative STOI of enhanced against clean 16 kHz waveforms
    (``stoi_loss.py:143``); -1 is perfectly intelligible. ``(B, T)`` or
    ``(B, T, 1)`` batches, relative ``lens``; ``reduction`` "mean", or
    anything else for the per-utterance vector.

    Example
    -------
    >>> import torch
    >>> a = torch.sin(torch.arange(16000, dtype=torch.float32))[None]
    >>> score = -stoi_loss(a + 0.001, a, torch.ones(1))
    >>> bool(0.69 < score < 0.81)
    True
    """
    y_pred_batch = torch.as_tensor(y_pred_batch).float()
    y_true_batch = torch.as_tensor(y_true_batch,
                                   device=y_pred_batch.device).float()
    if y_pred_batch.dim() == 3 and y_pred_batch.shape[-1] == 1:
        y_pred_batch = y_pred_batch[..., 0]
    if y_true_batch.dim() == 3 and y_true_batch.shape[-1] == 1:
        y_true_batch = y_true_batch[..., 0]

    batch_size = y_pred_batch.shape[0]
    if lens is None:
        lens = np.ones(batch_size, np.float32)
    lens = (lens.detach().cpu().numpy() if torch.is_tensor(lens)
            else np.asarray(lens))

    fs = 16000
    N = 30          # temporal envelope length
    J = 15.0        # number of bands
    dev = y_pred_batch.device
    octave_band = torch.as_tensor(thirdoct(fs=10000, nfft=512, num_bands=15,
                                           min_freq=150)[0], device=dev)
    c = 5.62341325  # 10^(-Beta/20), Beta = -15

    scores = []
    for i in range(batch_size):
        t = int(lens[i] * y_pred_batch.shape[1])
        y_true = _resample_1d(y_true_batch[i, :t], fs, 10000)
        y_pred = _resample_1d(y_pred_batch[i, :t], fs, 10000)

        y_sil_true, y_sil_pred = removeSilentFrames(y_true, y_pred)

        stft_true = _spectrogram_pow2(y_sil_true)
        stft_pred = _spectrogram_pow2(y_sil_pred)

        OCT_true = torch.sqrt(octave_band @ stft_true + 1e-14)   # (15, T')
        OCT_pred = torch.sqrt(octave_band @ stft_pred + 1e-14)

        M = int(stft_pred.shape[-1] - (N - 1))
        seg = torch.as_tensor(np.arange(N)[None, :] + np.arange(M)[:, None],
                              device=dev)                         # (M, 30)
        # rows m*15:(m+1)*15 = OCT[:, m:m+30]  ->  (M*15, 30)
        X = OCT_true.T[seg].permute(0, 2, 1).reshape(M * 15, N)
        Y = OCT_pred.T[seg].permute(0, 2, 1).reshape(M * 15, N)

        alpha = (torch.linalg.norm(X, dim=-1, keepdim=True)
                 / (torch.linalg.norm(Y, dim=-1, keepdim=True) + _SMALL))
        ay = Y * alpha
        yc = torch.minimum(ay, X + X * c)

        xn = X - X.mean(dim=-1, keepdim=True)
        xn = xn / (torch.linalg.norm(xn, dim=-1, keepdim=True) + _SMALL)
        yn = yc - yc.mean(dim=-1, keepdim=True)
        yn = yn / (torch.linalg.norm(yn, dim=-1, keepdim=True) + _SMALL)
        scores.append((xn * yn).sum() / (J * M))

    D = torch.stack(scores)
    if reduction == "mean":
        return -D.mean()
    return -D

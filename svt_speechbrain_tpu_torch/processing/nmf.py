"""Non-negative matrix factorization for source separation (port of
``svt_speechbrain_tpu/processing/nmf.py``, the analogue of SpeechBrain's
``processing/NMF.py``).

The factorizations are the JAX module's host numpy code, copied:
``nmf_factorize`` and ``separate_sources`` (template training and a
two-dictionary Wiener-style split), and ``NMF_separate_spectra``, the
reference's fixed-W multiplicative updates on simplex-normalized
activations, including its permute-then-reshape quirk (the NMF "columns"
straddle frame boundaries, as the reference's code does for its (BS, F, T)
layout). ``reconstruct_results`` resynthesizes with the port's
``spectral_magnitude`` and ``ISTFT``: the eps-softmask on the power-2
magnitude, the mixture phase, and the 1/(10·std) output scaling.
"""
from __future__ import annotations

import numpy as np
import torch

from svt_speechbrain_tpu_torch.processing.features import (ISTFT,
                                                             spectral_magnitude)


def nmf_factorize(V, rank=20, n_iter=100, eps=1e-10, seed=0):
    """Multiplicative-update NMF: V ≈ W H with KL divergence
    (template-dictionary training utility; the reference keeps this in its
    recipes, not core).

    Example
    -------
    >>> import numpy as np
    >>> V = np.outer([1.0, 2.0, 3.0], [1.0, 0.5, 2.0, 1.0])  # rank-1 exactly
    >>> W, H = nmf_factorize(V, rank=1, n_iter=200)
    >>> bool(np.allclose(W @ H, V, atol=1e-6))
    True
    """
    rng = np.random.default_rng(seed)
    V = np.maximum(np.asarray(V, dtype=np.float64), eps)
    f, t = V.shape
    W = rng.random((f, rank)) + eps
    H = rng.random((rank, t)) + eps
    ones = np.ones_like(V)
    for _ in range(n_iter):
        WH = W @ H + eps
        H *= (W.T @ (V / WH)) / (W.T @ ones + eps)
        WH = W @ H + eps
        W *= ((V / WH) @ H.T) / (ones @ H.T + eps)
        W /= W.sum(axis=0, keepdims=True) + eps
    return W, H


def separate_sources(mixture_mag, W1, W2, n_iter=100, eps=1e-10, seed=0):
    """Wiener-style separation with two pre-trained spectral dictionaries
    (KL updates + soft mask; convenience twin of ``NMF_separate_spectra``).

    Example
    -------
    >>> import numpy as np
    >>> W1 = np.array([[1.0], [0.0]])   # source 1 lives in bin 0
    >>> W2 = np.array([[0.0], [1.0]])   # source 2 lives in bin 1
    >>> V = np.array([[2.0, 0.0],       # mixture magnitudes (F=2, T=2)
    ...               [0.0, 3.0]])
    >>> S1, S2 = separate_sources(V, W1, W2, n_iter=50)
    >>> np.round(S1, 2)
    array([[2., 0.],
           [0., 0.]])
    >>> np.round(S2, 2)
    array([[0., 0.],
           [0., 3.]])
    """
    rng = np.random.default_rng(seed)
    V = np.maximum(np.asarray(mixture_mag, dtype=np.float64), eps)
    W = np.concatenate([W1, W2], axis=1)
    k1 = W1.shape[1]
    H = rng.random((W.shape[1], V.shape[1])) + eps
    ones = np.ones_like(V)
    for _ in range(n_iter):
        WH = W @ H + eps
        H *= (W.T @ (V / WH)) / (W.T @ ones + eps)
    V1 = W[:, :k1] @ H[:k1]
    V2 = W[:, k1:] @ H[k1:]
    total = V1 + V2 + eps
    return V * V1 / total, V * V2 / total


def spectral_phase(stft, power=2, log=False):
    """Phase of a complex stft stack (…, 2) (reference ``NMF.py:11``)."""
    del power, log
    stft = np.asarray(stft)
    return np.arctan2(stft[..., 1], stft[..., 0])


def NMF_separate_spectra(Whats, Xmix, n_iter=1000, eps=1e-20, h_init=None,
                         seed=0):
    """Separate mixture magnitude spectra with two pre-trained NMF template
    dictionaries — the reference's exact algorithm (``NMF.py:31``):
    columns are simplex-normalized, the activations ``h`` take ``n_iter``
    fixed-W multiplicative updates with per-column renormalization, then the
    per-source reconstructions ``W_k h_k`` are returned.

    ``Xmix``: (BS, T, F) batched (``F = n_fft//2 + 1`` must equal the
    template rows) or (T, F). Returns (X1hat, X2hat) of shape (BS, F, T).
    ``h_init`` fixes the activation init (the reference draws ``0.1·rand``)
    — used by the golden tests.

    Reference quirk mirrored bit-for-bit: its permute-then-reshape flattens
    the permuted (BS, F, T) buffer into rows of length F, so the NMF
    "columns" straddle true frame boundaries (content-scrambled frames).
    Shapes follow the docstring contract; the factorization still separates
    because every scrambled column remains a non-negative mixture of the
    same templates."""
    W1 = np.asarray(Whats[0], dtype=np.float32)
    W2 = np.asarray(Whats[1], dtype=np.float32)
    Xmix = np.asarray(Xmix, dtype=np.float32)
    batched = Xmix.ndim == 3
    if not batched:
        Xmix = Xmix[None]
    bs, t, f = Xmix.shape
    # reference transform: permuted (BS, F, T) buffer -> rows of F -> (F, BS*T)
    x = np.ascontiguousarray(np.transpose(Xmix, (0, 2, 1))).reshape(-1, f).T
    n = x.shape[1]

    g = x.sum(axis=0) + eps
    z = x / g

    w = np.concatenate([W1, W2], axis=1)
    k, k1 = w.shape[1], W1.shape[1]
    if h_init is None:
        h = 0.1 * np.random.default_rng(seed).random((k, n)).astype(np.float32)
    else:
        h = np.asarray(h_init, dtype=np.float32).copy()
    h /= h.sum(axis=0) + eps

    for _ in range(n_iter):
        v = z / (w @ h + eps)
        nh = h * (w.T @ v)
        h = nh / (nh.sum(axis=0) + eps)
    h *= g

    def split(xhat):
        return np.stack(np.split(xhat, bs, axis=1))  # (BS, F, T)

    x1 = split(w[:, :k1] @ h[:k1])
    x2 = split(w[:, k1:] @ h[k1:])
    if not batched:
        return x1[0], x2[0]
    return x1, x2


def reconstruct_results(X1hat, X2hat, X_stft, sample_rate, win_length,
                        hop_length):
    """Resynthesize separated spectra into waveforms — reference-exact
    (``NMF.py:105``): eps-softmask on the power-2 spectral magnitude, the
    mixture phase, inverse STFT, and 1/(10·std) scaling. Returns
    (x1hats, x2hats) lists of per-item waveforms.

    ``X1hat``/``X2hat``: (BS, F, T); ``X_stft``: (BS, F, T, 2)."""
    X1hat = np.asarray(X1hat, dtype=np.float64)
    X2hat = np.asarray(X2hat, dtype=np.float64)
    X_stft = np.asarray(X_stft)
    istft = ISTFT(sample_rate=sample_rate, win_length=win_length,
                  hop_length=hop_length)
    phase_mix = spectral_phase(X_stft)                       # (BS, F, T)
    mag_mix = spectral_magnitude(torch.as_tensor(X_stft), power=2).numpy()

    eps = 1e-25
    x1hats, x2hats = [], []
    for i in range(X1hat.shape[0]):
        total = eps + X1hat[i] + X2hat[i]
        unit_phase = np.stack([np.cos(phase_mix[i]), np.sin(phase_mix[i])],
                              axis=-1)                       # (F, T, 2)
        # torch.istft(center=True) trims n_fft//2 from BOTH ends
        t_frames = X1hat.shape[-1]
        torch_len = (istft.hop_length * (t_frames - 1) + istft.win_length
                     - istft.n_fft)
        for xhat, out in ((X1hat[i], x1hats), (X2hat[i], x2hats)):
            spec = (xhat / total)[..., None] * mag_mix[i][..., None] * unit_phase
            # (F, T, 2) -> (1, T, F, 2) for the ISTFT
            wav = istft(torch.as_tensor(
                np.transpose(spec, (1, 0, 2))[None], dtype=torch.float32),
                sig_length=torch_len).numpy()
            out.append(wav / (10 * wav.std()))
    return x1hats, x2hats

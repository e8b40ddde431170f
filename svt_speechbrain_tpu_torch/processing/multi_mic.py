"""Multi-microphone processing: covariance, TDOA localization, beamforming
(port of ``svt_speechbrain_tpu/processing/multi_mic.py``, the analogue of
SpeechBrain's ``processing/multi_mic.py``).

The tensor contracts are the JAX module's:

- STFT inputs ``Xs``: ``(batch, time, n_fft/2+1, 2, n_mics)``, real/imag
  stacked on axis 3.
- Covariance matrices: packed upper-triangular ``(batch, time, F, 2, P)``
  with ``P = M(M+1)/2`` entries ordered by ``triu_indices(M, M)``.
- TDOAs (``GccPhat`` output, the beamformers' localization input):
  ``(batch, time, P)`` fractional delays in samples, one per triu pair.
- Localization (``SrpPhat``/``Music``) outputs: per-frame unit directions
  ``(batch, time, 3)`` drawn from ``sphere()``.

Inside a module the algebra runs on torch complex tensors on the inputs'
device, in their precision (complex64 for f32, complex128 for f64). As in
the JAX module, the reference's ``torch.unique``-over-time passes are left
out: the math is applied per frame either way. The modules hold no
parameters; ``SrpPhat`` and ``Music`` keep their direction grid and delays
as buffers that follow them to a device. ``Music`` scores its directions in
slices of frames, so that its (frames, directions, F, noise) projection
stays within ``MUSIC_CHUNK_ELEMENTS``.

Reference: ``speechbrain/processing/multi_mic.py`` (Covariance:85,
DelaySum:198, Mvdr:336, Gev:513, GccPhat:643, SrpPhat:838, Music:1025,
doas2taus:1228, tdoas2taus:1272, steering:1317, sphere:1383).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from svt_speechbrain_tpu_torch.processing import decomposition as eig

# the most complex elements of one slice of Music's projection
MUSIC_CHUNK_ELEMENTS = 1 << 27


_real = eig._real


def _to_complex(xs):
    """(…, 2, M) stacked re/im → complex (…, M)."""
    xs = _real(xs)
    return torch.complex(xs[..., 0, :], xs[..., 1, :])


def _from_complex(x):
    """Complex (…, M) → (…, 2, M) stacked re/im."""
    return torch.stack([x.real, x.imag], dim=-2)


class Covariance(nn.Module):
    """Per-frequency spatial covariance of a multi-channel STFT
    (``multi_mic.py:48``): ``Xs (B, T, F, 2, M)`` → packed upper-triangular
    ``XXs (B, T, F, 2, P)``, pair (i, j) holding conj(x_i)·x_j. With
    ``average=True`` every frame carries the time-averaged covariance.

    Example
    -------
    >>> import torch
    >>> Xs = torch.zeros(1, 4, 3, 2, 2)
    >>> Xs[..., 0, 0] = 1.0   # mic 0 = 1+0j everywhere
    >>> Xs[..., 1, 1] = 1.0   # mic 1 = 0+1j everywhere
    >>> XXs = Covariance()(Xs)
    >>> XXs.shape              # P = 2*3/2 = 3 pairs
    torch.Size([1, 4, 3, 2, 3])
    >>> XXs[0, 0, 0]           # (0,0)=1, (0,1)=conj(1)·j=+j, (1,1)=1
    tensor([[1., 0., 1.],
            [0., 1., 0.]])
    """

    def __init__(self, average=True):
        super().__init__()
        self.average = average

    def forward(self, xs):
        x = _to_complex(xs)                                 # (B, T, F, M)
        iu = torch.triu_indices(x.shape[-1], x.shape[-1], device=x.device)
        cov = x[..., iu[0]].conj() * x[..., iu[1]]          # (B, T, F, P)
        if self.average:
            cov = cov.mean(dim=1, keepdim=True).expand(cov.shape)
        return _from_complex(cov)


def _taus(localization_tensor, doa_mode, mics, fs, c):
    if doa_mode:
        return doas2taus(localization_tensor, mics=mics, fs=fs, c=c)
    return tdoas2taus(localization_tensor)


class DelaySum(nn.Module):
    """Delay-and-sum beamforming (``multi_mic.py:88``): steer to the
    TDOAs/DOAs and average the aligned channels, ``Ys = Σ_m conj(a_m)·X_m
    / M`` → ``(B, T, F, 2, 1)``."""

    def forward(self, xs, localization_tensor, doa_mode=False, mics=None,
                fs=None, c=343.0):
        """``xs (B, T, F, 2, M)``; ``localization_tensor`` is TDOAs
        ``(B, T, P)`` (or DOAs ``(B, T, 3)`` with ``doa_mode=True`` plus
        ``mics (M, 3)`` and ``fs``)."""
        x = _to_complex(xs)
        taus = _taus(localization_tensor, doa_mode, mics, fs, c)
        a = _steering_complex(taus, xs.shape[2], x.real.dtype)
        out = (a.conj() * x).sum(dim=-1, keepdim=True) / x.shape[-1]
        return _from_complex(out)


class Mvdr(nn.Module):
    """Minimum-variance distortionless-response beamforming
    (``multi_mic.py:110``): ``w = N⁻¹a / Re(aᴴN⁻¹a)`` with the noise
    covariance loaded by ``decomposition.inv``'s trace-scaled diagonal,
    then ``Ys = Σ conj(w)·X``. ``eps`` is kept for the signature, unused
    as in the reference's forward."""

    def __init__(self, eps=1e-20):
        super().__init__()
        self.eps = eps

    def forward(self, xs, nns, localization_tensor, doa_mode=False,
                mics=None, fs=None, c=343.0):
        """``xs (B, T, F, 2, M)``; ``nns`` packed noise covariance
        ``(B, T, F, 2, P)``; ``localization_tensor`` as in ``DelaySum``."""
        x = _to_complex(xs)
        taus = _taus(localization_tensor, doa_mode, mics, fs, c)
        a = _steering_complex(taus, xs.shape[2], x.real.dtype)
        nns_inv = eig.inv(nns)                      # (B, T, F, M, M, 2)
        n_inv = torch.complex(nns_inv[..., 0], nns_inv[..., 1])
        n_inv_a = torch.einsum("...ij,...j->...i", n_inv, a)
        alpha = 1.0 / torch.einsum("...i,...i->...", a.conj(), n_inv_a).real
        w = n_inv_a * alpha[..., None]
        return _from_complex((w.conj() * x).sum(dim=-1, keepdim=True))


class Gev(nn.Module):
    """Generalized-eigenvalue beamforming (``multi_mic.py:144``): w = the
    principal generalized eigenvector of (Φss, pos_def(Φnn)), unit-
    normalized, applied unconjugated (``Ys = Σ w·X``, the reference's
    convention). The output inherits the eigensolver's per-frequency phase;
    its magnitude does not depend on it."""

    def forward(self, xs, sss, nns):
        """``xs (B, T, F, 2, M)``; ``sss``/``nns`` packed covariances
        ``(B, T, F, 2, P)``."""
        m = xs.shape[-1]
        vs, _ = eig.gevd(sss, eig.pos_def(nns))     # (B, T, F, M, M, 2)
        w = torch.complex(vs[..., m - 1, 0], vs[..., m - 1, 1])
        w = w / torch.sqrt((w.abs() ** 2).sum(dim=-1, keepdim=True))
        x = _to_complex(xs)
        return _from_complex((w * x).sum(dim=-1, keepdim=True))


class GccPhat(nn.Module):
    """Generalized cross-correlation with phase transform
    (``multi_mic.py:165``): packed covariances → fractional TDOAs ``(B, T,
    P)``, one per triu pair, from the argmax of the PHAT-weighted
    cross-correlation (the first maximum) refined by quadratic
    interpolation.

    Example
    -------
    >>> import numpy as np, torch
    >>> rng = np.random.default_rng(0)
    >>> x = rng.normal(size=(1, 64 + 8)).astype(np.float32)
    >>> sig = np.stack([x[:, 8:], x[:, :64]], axis=-1)  # mic1 lags by 8
    >>> spec = np.fft.rfft(sig, axis=1)                 # toy 1-frame "STFT"
    >>> Xs = torch.tensor(np.stack([spec.real, spec.imag], 2)[:, None],
    ...                   dtype=torch.float32)
    >>> tdoas = GccPhat()(Covariance()(Xs))
    >>> tdoas[0, 0].round(decimals=1).abs()             # (0,0),(0,1),(1,1)
    tensor([0., 8., 0.])
    """

    def __init__(self, tdoa_max=None, eps=1e-20):
        super().__init__()
        self.tdoa_max = tdoa_max
        self.eps = eps

    def forward(self, xxs):
        n_fft = (xxs.shape[2] - 1) * 2
        cov = _to_complex(xxs)                              # (B, T, F, P)
        phat = cov / (cov.abs() + self.eps)
        cc = torch.fft.irfft(phat.movedim(2, -1), n=n_fft, dim=-1)
        cc = cc.movedim(-1, 2)                              # (B, T, n_fft, P)
        tdoa_max = n_fft // 2 if self.tdoa_max is None else int(self.tdoa_max)
        sliced = torch.cat([cc[..., :tdoa_max, :], cc[..., -tdoa_max:, :]],
                           dim=2)
        idx = sliced.argmax(dim=2)                          # (B, T, P)
        offset = n_fft - sliced.shape[2]
        delays = torch.where(idx >= tdoa_max, idx + offset - n_fft, idx)

        def take(at):
            return torch.gather(cc, 2, ((at + n_fft) % n_fft)[..., None, :]
                                )[..., 0, :]

        y1, y2, y3 = take(delays - 1), take(delays), take(delays + 1)
        return delays + (y1 - y3) / (2 * y1 - 4 * y2 + 2 * y3)


class _Grid(nn.Module):
    """The ``sphere()`` grid of directions and their per-mic delays, as
    buffers."""

    def __init__(self, mics, space, sample_rate, speed_sound, what):
        super().__init__()
        if space == "circle":
            raise NotImplementedError(
                f"space='circle' is unimplemented in the reference too "
                f"(multi_mic.py:{what})")
        doas = sphere()
        self.register_buffer("doas", doas, persistent=False)
        self.register_buffer("taus", doas2taus(doas, mics=mics,
                                               fs=sample_rate, c=speed_sound),
                             persistent=False)


class SrpPhat(_Grid):
    """Steered-response-power localization with phase transform
    (``multi_mic.py:213``): scan the ``sphere()`` grid and return, per
    frame, the direction whose steered pairwise coherence is largest —
    ``(B, T, 3)``."""

    def __init__(self, mics, space="sphere", sample_rate=16000,
                 speed_sound=343.0, eps=1e-20):
        super().__init__(mics, space, sample_rate, speed_sound, 920)
        self.eps = eps

    def forward(self, xxs):
        cov = _to_complex(xxs)                              # (B, T, F, P)
        a = _steering_complex(self.taus, xxs.shape[2], cov.real.dtype)
        iu = torch.triu_indices(a.shape[-1], a.shape[-1], device=a.device)
        w = (a[..., iu[0]].conj() * a[..., iu[1]]).reshape(a.shape[0], -1)
        phat = cov / (cov.abs() + self.eps)
        phat = phat.reshape(phat.shape[:2] + (-1,))         # (B, T, F*P)
        # the reference keeps Re(XX·W), not conj(W) (multi_mic.py:1013)
        power = phat.real @ w.real.T - phat.imag @ w.imag.T  # (B, T, D)
        return self.doas.to(cov.real.dtype)[power.argmax(dim=-1)]


class Music(_Grid):
    """MUSIC localization (``multi_mic.py:250``): per frame, the direction
    whose steering vector is most orthogonal to the noise subspace — the
    ``n_mics − n_sig`` SMALLEST left-singular vectors of the covariance
    (``decomposition.svdl``, ascending) — → ``(B, T, 3)``. The reference
    sums |aᴴ·u_k| (magnitudes, not their squares), which no column's phase
    moves."""

    def __init__(self, mics, space="sphere", sample_rate=16000,
                 speed_sound=343.0, eps=1e-20, n_sig=1):
        super().__init__(mics, space, sample_rate, speed_sound, 1121)
        self.eps = eps
        self.n_sig = n_sig

    def forward(self, xxs):
        n_fft = xxs.shape[2]
        us, _ = eig.svdl(xxs)                       # (B, T, F, M, M, 2)
        m = us.shape[-2]
        a = _steering_complex(self.taus, n_fft, us.dtype)   # (D, F, M)
        noise = torch.complex(us[..., : m - self.n_sig, 0],
                              us[..., : m - self.n_sig, 1])
        lead = noise.shape[:2]
        noise = noise.reshape((-1,) + noise.shape[2:])      # (N, F, M, K)
        num = (a.abs() ** 2).sum(dim=-1)                    # (D, F)
        per = a.shape[0] * n_fft * max(noise.shape[-1], 1)
        step = max(1, MUSIC_CHUNK_ELEMENTS // per)
        spectra = []
        for i in range(0, noise.shape[0], step):
            proj = torch.einsum("dfm,nfmk->ndfk", a.conj(),
                                noise[i:i + step])
            ps = num / (proj.abs().sum(dim=-1) + self.eps)  # (n, D, F)
            spectra.append(ps.sum(dim=-1) / n_fft)
        spectrum = torch.cat(spectra).reshape(lead + (a.shape[0],))
        return self.doas.to(us.dtype)[spectrum.argmax(dim=-1)]


def doas2taus(doas, mics, fs, c=343.0):
    """Directions of arrival (unit xyz, (…, 3)) → per-mic delays in samples
    (``multi_mic.py:289``): τ = (fs/c)·⟨doa, micᵀ⟩, in f32 (f64 when the
    directions are f64)."""
    doas = _real(doas)
    mics = torch.as_tensor(np.asarray(mics) if not torch.is_tensor(mics)
                           else mics, device=doas.device).to(doas.dtype)
    return (fs / c) * (doas @ mics.T)


def tdoas2taus(tdoas):
    """Each channel's delay against mic 0 from a ``GccPhat`` TDOA tensor of
    packed width M + M(M−1)/2: the first M triu entries are the (0, k)
    pairs (``multi_mic.py:296``)."""
    n = tdoas.shape[-1]
    return tdoas[..., :int(((1 + 8 * n) ** 0.5 - 1) / 2)]


def _steering_complex(taus, n_fft, dtype=torch.float32):
    """Delays (…, M) → complex steering vectors (…, F, M), a = e^{−jωτ},
    in ``dtype``'s precision."""
    taus = torch.as_tensor(taus).to(dtype)
    frame_size = int((n_fft - 1) * 2)
    omegas = (2 * math.pi * torch.arange(n_fft, dtype=dtype,
                                         device=taus.device) / frame_size)
    phase = -omegas[:, None] * taus[..., None, :]
    return torch.complex(torch.cos(phase), torch.sin(phase))


def steering(taus, n_fft):
    """Delays (…, M) → steering vectors (…, F, 2, M) with a = e^{−jωτ}
    stacked re/im (``multi_mic.py:314``).

    Example
    -------
    >>> import torch
    >>> As = steering(torch.tensor([[0.0, 2.0]]), n_fft=5)  # ω_2·τ = π
    >>> As[0, 2].round(decimals=5).abs().tolist()     # |re|, |im| per mic
    [[1.0, 1.0], [0.0, 0.0]]
    >>> As[0, 2, 0].round(decimals=5).tolist()        # a = 1 and −1
    [1.0, -1.0]
    """
    return _from_complex(_steering_complex(taus, n_fft,
                                           _real(taus).dtype))


def sphere(levels_count=4):
    """Near-uniform unit directions from a subdivided icosahedron
    (``multi_mic.py:330``) in the reference's point order: each level
    splits every triangle in four, each new point is the normalized sum of
    a vertex pair, and the new points are ordered by ascending pair key
    i·(K+1)+j. Level counts: 1 → 42, 2 → 162, 3 → 642, 4 → 2562 points
    (f32, built on the host).

    Example
    -------
    >>> pts = sphere(levels_count=1)
    >>> pts.shape
    torch.Size([42, 3])
    >>> float((pts.square().sum(dim=1) - 1).abs().max()) < 1e-5
    True
    """
    h = (5.0 ** 0.5) / 5.0
    r = (2.0 / 5.0) * (5.0 ** 0.5)
    pi = 3.141592654  # the reference's literal (multi_mic.py:1421)
    pts = np.zeros((12, 3), dtype=np.float32)
    pts[0] = [0, 0, 1]
    pts[11] = [0, 0, -1]
    ang = 2.0 * pi * np.arange(5, dtype=np.float32) / 5.0
    pts[1:6, 0], pts[1:6, 1], pts[1:6, 2] = (r * np.sin(ang),
                                             r * np.cos(ang), h)
    pts[6:11, 0], pts[6:11, 1], pts[6:11, 2] = (-r * np.sin(ang),
                                                -r * np.cos(ang), -h)
    trs = np.array([
        [0, 2, 1], [0, 3, 2], [0, 4, 3], [0, 5, 4], [0, 1, 5],
        [9, 1, 2], [10, 2, 3], [6, 3, 4], [7, 4, 5], [8, 5, 1],
        [4, 7, 6], [5, 8, 7], [1, 9, 8], [2, 10, 9], [3, 6, 10],
        [11, 6, 7], [11, 7, 8], [11, 8, 9], [11, 9, 10], [11, 10, 6]],
        dtype=np.int64)

    for _ in range(levels_count):
        t0, t1, t2 = trs[:, 0], trs[:, 1], trs[:, 2]
        corner1 = np.concatenate([np.stack([t0, t0], 1), np.stack([t0, t1], 1),
                                  np.stack([t2, t0], 1), np.stack([t0, t1], 1)])
        corner2 = np.concatenate([np.stack([t0, t1], 1), np.stack([t1, t1], 1),
                                  np.stack([t1, t2], 1), np.stack([t1, t2], 1)])
        corner3 = np.concatenate([np.stack([t2, t0], 1), np.stack([t1, t2], 1),
                                  np.stack([t2, t2], 1), np.stack([t2, t0], 1)])
        flat = np.sort(np.concatenate([corner1, corner2, corner3]), axis=1)
        key = flat[:, 0] * (flat.max() + 1) + flat[:, 1]
        uniq, inverse = np.unique(key, return_inverse=True)
        i = uniq // (flat.max() + 1)
        j = uniq - i * (flat.max() + 1)
        trs = inverse.reshape(3, -1).T
        pts = pts[i] + pts[j]
        pts /= np.sqrt(np.sum(pts ** 2, axis=1, keepdims=True))
    return torch.from_numpy(pts)

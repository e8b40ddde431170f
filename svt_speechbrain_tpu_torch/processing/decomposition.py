"""Generalized eigenvalue decomposition of complex Hermitian matrices (port
of ``svt_speechbrain_tpu/processing/decomposition.py``, the analogue of
SpeechBrain's ``processing/decomposition.py``).

A complex Hermitian matrix crosses a module boundary packed as its
upper-triangular part in a ``(*, 2, P)`` tensor — axis -2 holds [real,
imag] and the last axis runs over ``triu_indices(C, C)`` — and full
matrices as ``(*, C, C, 2)`` stacked real/imag. Inside, the algebra runs on
torch complex tensors (complex64 for f32 inputs, complex128 for f64):
``torch.linalg.cholesky``, ``inv`` and ``eigh``, which are LAPACK on the
CPU and cuSOLVER on the card (``eigh`` in slices of ``EIGH_BATCH``
matrices, a batch size cuSOLVER's batched solver was seen to take).
Eigenvalues come in ascending order, as the reference's; each eigenvector
column carries a phase the solver is free to choose (the JAX package, the
CPU and the card each choose their own), so only phase-free quantities of
the vectors are comparable across them.

Reference: ``speechbrain/processing/decomposition.py`` (gevd:16, svdl:117,
f:182, finv:223, g:254, ginv:286, pos_def:315, inv:358).
"""
from __future__ import annotations

import numpy as np
import torch

# the most matrices one batched ``eigh`` is given. On an H100 (torch 2.11,
# CUDA 12.8) cuSOLVER's batched syev, torch's route for small matrices on
# CUDA, took a batch of 16384 and refused batches of 32767 and 32768 with
# CUSOLVER_STATUS_INVALID_VALUE (``tools/eigh_batch_probe.py``); where
# between 16384 and 32767 the limit lies was not measured
EIGH_BATCH = 16384


def _eigh(m):
    """``torch.linalg.eigh`` of a batch of Hermitian matrices, in slices
    of at most ``EIGH_BATCH`` matrices."""
    flat = m.reshape((-1,) + m.shape[-2:])
    parts = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])
             for i in range(0, flat.shape[0], EIGH_BATCH)]
    vals = torch.cat([p[0] for p in parts])
    vecs = torch.cat([p[1] for p in parts])
    return vals.reshape(m.shape[:-1]), vecs.reshape(m.shape)


def _num_channels(p):
    """P = C(C+1)/2 packed length → C."""
    return int(round(((1 + 8 * p) ** 0.5 - 1) / 2))


def _real(x):
    """A real float tensor of ``x`` (f32 unless it is f64)."""
    x = torch.as_tensor(x)
    return x if x.dtype == torch.float64 else x.to(torch.float32)


def _triu(c, device):
    return torch.triu_indices(c, c, device=device)


def _unpack(ws):
    """Packed ``(*, 2, P)`` upper triangle → full complex Hermitian
    ``(*, C, C)``."""
    ws = _real(ws)
    c = _num_channels(ws.shape[-1])
    iu = _triu(c, ws.device)
    vals = torch.complex(ws[..., 0, :], ws[..., 1, :])
    m = vals.new_zeros(ws.shape[:-2] + (c, c))
    m[..., iu[0], iu[1]] = vals
    lower = m.transpose(-1, -2).conj()
    eye = torch.eye(c, dtype=m.dtype, device=m.device)
    return m + lower - m * eye


def _pack(m):
    """Full complex Hermitian ``(*, C, C)`` → packed ``(*, 2, P)``."""
    iu = _triu(m.shape[-1], m.device)
    vals = m[..., iu[0], iu[1]]
    return torch.stack([vals.real, vals.imag], dim=-2)


def _stack(m):
    """Complex ``(*, C, C)`` → ``(*, C, C, 2)`` stacked real/imag."""
    return torch.stack([m.real, m.imag], dim=-1)


def _diag(vals, c):
    """Real eigen/singular values (*, C) → ``(*, C, C, 2)``, the values
    on the real diagonal."""
    ds = vals.new_zeros(vals.shape[:-1] + (c, c, 2))
    idx = torch.arange(c, device=vals.device)
    ds[..., idx, idx, 0] = vals
    return ds


def f(ws):
    """Packed upper triangle ``(*, 2, C+P)`` → interleaved real block matrix
    ``(*, 2C, 2C)`` where entry (i, j) expands to ``[[re, -im], [im, re]]``
    (``decomposition.py:51``).

    Example
    -------
    >>> import torch
    >>> ws = torch.zeros(2, 3)              # C=2: entries (0,0),(0,1),(1,1)
    >>> ws[0] = torch.tensor([1.0, 2.0, 3.0])
    >>> ws[1, 1] = 4.0                      # M[0,1] = 2+4j
    >>> f(ws)[0::2, 0::2]
    tensor([[1., 2.],
            [2., 3.]])
    >>> float(f(ws)[0, 3]), float(f(ws)[1, 2])
    (-4.0, 4.0)
    """
    m = _unpack(ws)
    c = m.shape[-1]
    out = m.real.new_zeros(m.shape[:-2] + (2 * c, 2 * c))
    out[..., 0::2, 0::2] = m.real
    out[..., 1::2, 1::2] = m.real
    out[..., 0::2, 1::2] = -m.imag
    out[..., 1::2, 0::2] = m.imag
    return out


def finv(wsh):
    """Inverse of ``f``: interleaved block ``(*, 2C, 2C)`` → packed
    ``(*, 2, C+P)`` (``decomposition.py:79``)."""
    wsh = _real(wsh)
    iu = _triu(wsh.shape[-1] // 2, wsh.device)
    re = wsh[..., 0::2, 0::2][..., iu[0], iu[1]]
    im = -wsh[..., 0::2, 1::2][..., iu[0], iu[1]]
    return torch.stack([re, im], dim=-2)


def g(ws):
    """Full complex ``(*, C, C, 2)`` stacked re/im → interleaved real block
    ``(*, 2C, 2C)`` (``decomposition.py:90``)."""
    ws = _real(ws)
    c = ws.shape[-2]
    out = ws.new_zeros(ws.shape[:-3] + (2 * c, 2 * c))
    out[..., 0::2, 0::2] = ws[..., 0]
    out[..., 1::2, 1::2] = ws[..., 0]
    out[..., 0::2, 1::2] = -ws[..., 1]
    out[..., 1::2, 0::2] = ws[..., 1]
    return out


def ginv(wsh):
    """Inverse of ``g``: interleaved block ``(*, 2C, 2C)`` → stacked
    ``(*, C, C, 2)`` (``decomposition.py:103``)."""
    wsh = _real(wsh)
    return torch.stack([wsh[..., 0::2, 0::2], wsh[..., 1::2, 0::2]], dim=-1)


def pos_def(ws, alpha=0.001, eps=1e-20):
    """Diagonal loading: add ``alpha * trace + eps`` to the real diagonal of
    a packed Hermitian matrix (``decomposition.py:110``; the loading is
    trace-proportional).

    Example
    -------
    >>> import torch
    >>> ws = torch.zeros(2, 3)
    >>> ws[0] = torch.tensor([1.0, 0.0, 3.0])     # diag trace = 4
    >>> pos_def(ws, alpha=0.5)[0]
    tensor([3., 0., 5.])
    """
    ws = _real(ws)
    iu = np.triu_indices(_num_channels(ws.shape[-1]))
    diag = torch.as_tensor(np.nonzero(iu[0] == iu[1])[0], device=ws.device)
    re = ws[..., 0, :]
    trace = re[..., diag].sum(dim=-1, keepdim=True)
    re = re.index_add(-1, diag, (alpha * trace + eps).expand(
        re.shape[:-1] + (len(diag),)))
    return torch.stack([re, ws[..., 1, :]], dim=-2)


def inv(x):
    """Inverse of a packed complex Hermitian matrix, ``pos_def`` applied
    first (``decomposition.py:133``); the full inverse as ``(*, C, C, 2)``
    stacked real/imag."""
    return _stack(torch.linalg.inv(_unpack(pos_def(x))))


def gevd(a, b=None):
    """Generalized eigendecomposition A·V = B·V·D of packed complex
    Hermitian pairs (``decomposition.py:143``).

    Returns ``(vs, ds)`` both shaped ``(*, C, C, 2)``: ``vs`` columns are
    eigenvectors for ASCENDING eigenvalues; ``ds`` is the diagonal
    eigenvalue matrix. Without ``b`` the identity is used. Solved by
    Cholesky whitening (b = L·Lᴴ, ``eigh`` of L⁻¹·a·L⁻ᴴ, v = L⁻ᴴ·y).

    Example
    -------
    >>> import torch
    >>> a = torch.tensor([[52., 34, 16, 125, 41, 62], [0, 37, 28, 0, 3, 0]])
    >>> vs, ds = gevd(a)
    >>> ds[..., 0].diagonal().round(decimals=2)
    tensor([ 20.9500,  43.9400, 174.1100])
    """
    am = _unpack(a)
    c = am.shape[-1]
    if b is None:
        bm = torch.eye(c, dtype=am.dtype, device=am.device).expand(am.shape)
    else:
        bm = _unpack(b)
    L_inv = torch.linalg.inv(torch.linalg.cholesky(bm))
    L_inv_h = L_inv.transpose(-1, -2).conj()
    vals, y = _eigh(L_inv @ am @ L_inv_h)                   # ascending
    return _stack(L_inv_h @ y), _diag(vals, c)


def svdl(a):
    """Left singular vectors of a packed complex matrix from the
    eigendecomposition of A·Aᴴ (``decomposition.py:182``).

    Returns ``(us, ds)`` both ``(*, C, C, 2)`` in ASCENDING order — column
    0 is the SMALLEST singular direction (``multi_mic.Music`` takes its
    noise subspace from the first columns). ``ds`` holds the singular
    values (sqrt of the eigenvalues of A·Aᴴ, at least 0) on its real
    diagonal."""
    am = _unpack(a)
    vals, u = _eigh(am @ am.transpose(-1, -2).conj())
    return _stack(u), _diag(torch.sqrt(torch.clamp(vals, min=0.0)),
                            am.shape[-1])

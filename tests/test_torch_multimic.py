"""Port parity, multi-microphone processing: every module and geometry
helper of ``processing/multi_mic.py``, the transforms and eigensolvers of
``processing/decomposition.py`` and the ``DelaySum_Beamformer`` lobe, each
against the JAX package on the same seeded numpy inputs (the generators of
``tests/test_multimic_golden.py``: a broadband source reaching each mic
with its own integer delay, 16 kHz, and uncorrelated noise), on the CPU,
f32.

Tolerances: outputs of order 1 within 1e-5 (summation order only) unless a
case says otherwise. Eigenvectors are held through what no column phase
moves (an eigensolver may pick any phase a column, and XLA's and LAPACK's
pick their own): |vᴴ·v_jax| a column, the projector v·vᴴ and the residual
a·v − b·v·d; eigenvalues directly."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import beamform_multimic as jbf
from svt_speechbrain_tpu.processing import decomposition as jeig
from svt_speechbrain_tpu.processing import multi_mic as jmm
from svt_speechbrain_tpu.processing.features import STFT as JSTFT

from svt_speechbrain_tpu_torch.models import beamform_multimic as tbf
from svt_speechbrain_tpu_torch.processing import decomposition as teig
from svt_speechbrain_tpu_torch.processing import multi_mic as tmm

ATOL = 1e-5
MICS = np.array([[-0.05, -0.05, 0], [-0.05, 0.05, 0],
                 [0.05, 0.05, 0], [0.05, -0.05, 0]], np.float32)
DOA = np.array([0.6, 0.64, 0.48], np.float32)


def _delayed_stft(delays, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=n + 64).astype(np.float32)
    x = np.stack([base[32 - d: 32 - d + n] for d in delays], axis=-1)[None]
    return np.asarray(JSTFT(sample_rate=16000)(None, jnp.asarray(x)))


def _noise_stft(m, n=4000, seed=1):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(1, n, m)).astype(np.float32)
    return np.asarray(JSTFT(sample_rate=16000)(None, jnp.asarray(x)))


def _direction_stft(t=3, n_fft=201, seed=2):
    """One far-field source planted at ``DOA`` over ``MICS``."""
    rng = np.random.default_rng(seed)
    taus = np.asarray(jmm.doas2taus(DOA[None], MICS, fs=16000))[0]
    omega = 2 * np.pi * np.arange(n_fft) / ((n_fft - 1) * 2)
    s = rng.normal(size=(1, t, n_fft)) + 1j * rng.normal(size=(1, t, n_fft))
    x = s[..., None] * np.exp(1j * omega[:, None] * taus[None, :])
    x = x + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return np.stack([x.real, x.imag], axis=3).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return np.asarray(x)


DELAYS = [0, 4, -3, 2]


@pytest.mark.parametrize("average", [True, False])
def test_covariance(average):
    xs = _delayed_stft(DELAYS)
    got = tmm.Covariance(average=average)(_t(xs)).numpy()
    want = _j(jmm.Covariance(average=average)(None, xs))
    assert got.shape == want.shape == xs.shape[:3] + (2, 10)
    # the time average sums 26 frames of products of order 10-100
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tdoa_max", [None, 16])
def test_gccphat(tdoa_max):
    cov = _j(jmm.Covariance()(None, _delayed_stft(DELAYS)))
    got = tmm.GccPhat(tdoa_max=tdoa_max)(_t(cov)).numpy()
    want = _j(jmm.GccPhat(tdoa_max=tdoa_max)(None, jnp.asarray(cov)))
    assert got.shape == want.shape == cov.shape[:2] + (10,)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got[0, 0, 1:4], [4, -3, 2], atol=0.5)


def test_delaysum_tdoa_and_doa_modes():
    xs = _delayed_stft(DELAYS)
    cov = _j(jmm.Covariance()(None, xs))
    tdoas = _j(jmm.GccPhat()(None, jnp.asarray(cov)))
    got = tmm.DelaySum()(_t(xs), _t(tdoas)).numpy()
    want = _j(jmm.DelaySum()(None, xs, jnp.asarray(tdoas)))
    assert got.shape == want.shape == xs.shape[:3] + (2, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    doas = np.tile(DOA, (1, xs.shape[1], 1))
    got = tmm.DelaySum()(_t(xs), _t(doas), doa_mode=True, mics=MICS,
                         fs=16000).numpy()
    want = _j(jmm.DelaySum()(None, xs, jnp.asarray(doas), doa_mode=True,
                             mics=MICS, fs=16000))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mvdr():
    xs = _delayed_stft(DELAYS)
    nns = _j(jmm.Covariance()(None, _noise_stft(4)))
    tdoas = _j(jmm.GccPhat()(None, jmm.Covariance()(None, xs)))
    got = tmm.Mvdr()(_t(xs), _t(nns), _t(tdoas)).numpy()
    want = _j(jmm.Mvdr()(None, xs, jnp.asarray(nns), jnp.asarray(tdoas)))
    assert got.shape == want.shape
    # an inverse of the loaded 4x4 noise covariance in f32: outputs of
    # order 1-30 within 1e-5 of their size
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_gev_magnitude():
    ss, nn = _delayed_stft(DELAYS), _noise_stft(4)
    xs = ss + nn
    sss = _j(jmm.Covariance()(None, ss))
    nns = _j(jmm.Covariance()(None, nn))
    got = tmm.Gev()(_t(xs), _t(sss), _t(nns)).numpy()
    want = _j(jmm.Gev()(None, xs, jnp.asarray(sss), jnp.asarray(nns)))
    assert got.shape == want.shape
    mag = lambda y: np.hypot(y[..., 0, 0], y[..., 1, 0])     # noqa: E731
    # a principal eigenvector of a rank-1-like pencil in f32 through two
    # solvers: magnitudes of order 1-30 within 1e-4 of their size
    np.testing.assert_allclose(mag(got), mag(want), rtol=1e-4, atol=1e-3)


def test_srp_phat_and_music():
    xs = _direction_stft(t=3)
    cov = _j(jmm.Covariance()(None, xs))
    srp = tmm.SrpPhat(mics=MICS)(_t(cov)).numpy()
    np.testing.assert_array_equal(
        srp, _j(jmm.SrpPhat(mics=MICS)(None, jnp.asarray(cov))))
    music = tmm.Music(mics=MICS, n_sig=1)(_t(cov)).numpy()
    np.testing.assert_array_equal(
        music, _j(jmm.Music(mics=MICS, n_sig=1)(None, jnp.asarray(cov))))
    assert srp.shape == music.shape == (1, 3, 3)
    assert float(srp[0, 0] @ DOA) > 0.99 and float(music[0, 0] @ DOA) > 0.99
    # Music's spectrum in slices of frames equals it whole
    saved = tmm.MUSIC_CHUNK_ELEMENTS
    try:
        tmm.MUSIC_CHUNK_ELEMENTS = 1
        np.testing.assert_array_equal(
            tmm.Music(mics=MICS, n_sig=1)(_t(cov)).numpy(), music)
    finally:
        tmm.MUSIC_CHUNK_ELEMENTS = saved


def test_geometry_helpers():
    for levels in (1, 2, 4):
        np.testing.assert_array_equal(tmm.sphere(levels).numpy(),
                                      _j(jmm.sphere(levels)))
    doas = _j(jmm.sphere(1))
    np.testing.assert_allclose(
        tmm.doas2taus(_t(doas[None]), MICS, fs=16000).numpy(),
        _j(jmm.doas2taus(jnp.asarray(doas[None]), MICS, fs=16000)),
        atol=ATOL)
    rng = np.random.default_rng(0)
    tdoas = rng.normal(size=(2, 3, 6)).astype(np.float32)
    np.testing.assert_array_equal(tmm.tdoas2taus(_t(tdoas)).numpy(),
                                  _j(jmm.tdoas2taus(jnp.asarray(tdoas))))
    taus = rng.uniform(-5, 5, size=(2, 3, 4)).astype(np.float32)
    got = tmm.steering(_t(taus), n_fft=17).numpy()
    assert got.shape == (2, 3, 17, 2, 4)
    np.testing.assert_allclose(got, _j(jmm.steering(jnp.asarray(taus), 17)),
                               atol=ATOL)


def _random_packed(rng, batch=(3,), c=4):
    m = rng.normal(size=batch + (c, c)) + 1j * rng.normal(size=batch + (c, c))
    m = m @ np.conj(np.swapaxes(m, -1, -2)) + c * np.eye(c)
    iu = np.triu_indices(c)
    vals = m[..., iu[0], iu[1]]
    return np.stack([vals.real, vals.imag], axis=-2).astype(np.float32)


def test_decomposition_transforms():
    ws = _random_packed(np.random.default_rng(0))
    np.testing.assert_array_equal(teig.f(_t(ws)).numpy(), _j(jeig.f(ws)))
    np.testing.assert_array_equal(teig.finv(teig.f(_t(ws))).numpy(),
                                  _j(jeig.finv(jeig.f(ws))))
    full = _j(jeig.ginv(jeig.f(ws)))
    np.testing.assert_array_equal(teig.ginv(teig.f(_t(ws))).numpy(), full)
    np.testing.assert_array_equal(teig.g(_t(full)).numpy(), _j(jeig.g(full)))
    np.testing.assert_allclose(teig.pos_def(_t(ws), alpha=0.01).numpy(),
                               _j(jeig.pos_def(ws, alpha=0.01)), rtol=1e-6)
    # the inverse of a matrix with entries of order 10 (inverse ~0.1)
    np.testing.assert_allclose(teig.inv(_t(ws)).numpy(), _j(jeig.inv(ws)),
                               atol=ATOL)


def _complex(v):
    return v[..., 0] + 1j * v[..., 1]


def _hold_vectors(vs, jvs, a=None, b=None, d=None, atol=1e-4):
    """Eigenvector columns through phase-free quantities: |vᴴ·v_jax| of
    each column against |v_jax|², the projector of each column, and the
    residual a·v − b·v·d."""
    v, jv = _complex(vs), _complex(jvs)
    inner = np.abs(np.sum(np.conj(v) * jv, axis=-2))
    np.testing.assert_allclose(inner, np.sum(np.abs(jv) ** 2, axis=-2),
                               rtol=1e-4)
    proj = np.einsum("...ik,...jk->...kij", v, np.conj(v))
    jproj = np.einsum("...ik,...jk->...kij", jv, np.conj(jv))
    np.testing.assert_allclose(proj, jproj, atol=atol)
    if a is not None:
        resid = a @ v - b @ v * d[..., None, :]
        scale = np.abs(a @ v).max()
        assert np.abs(resid).max() <= 1e-5 * scale


@pytest.mark.parametrize("with_b", [True, False])
def test_gevd(with_b):
    rng = np.random.default_rng(1)
    a, b = _random_packed(rng), _random_packed(rng)
    bb = b if with_b else None
    vs, ds = teig.gevd(_t(a), None if bb is None else _t(bb))
    jvs, jds = jeig.gevd(a, bb)
    # eigenvalues of order 1-100 in f32 through two solvers
    np.testing.assert_allclose(ds.numpy(), _j(jds), rtol=1e-5, atol=1e-4)
    am = _complex(_j(jeig.ginv(jeig.f(a))))
    bm = (_complex(_j(jeig.ginv(jeig.f(b)))) if with_b
          else np.broadcast_to(np.eye(4), am.shape))
    _hold_vectors(vs.numpy(), _j(jvs), am, bm,
                  np.diagonal(ds.numpy()[..., 0], axis1=-2, axis2=-1))


def test_svdl():
    a = _random_packed(np.random.default_rng(2))
    us, ds = teig.svdl(_t(a))
    jus, jds = jeig.svdl(a)
    np.testing.assert_allclose(ds.numpy(), _j(jds), rtol=1e-5, atol=1e-4)
    _hold_vectors(us.numpy(), _j(jus))


def test_decomposition_f64_keeps_f64():
    a = _random_packed(np.random.default_rng(3)).astype(np.float64)
    vs, ds = teig.gevd(_t(a))
    assert vs.dtype == ds.dtype == torch.float64
    vs32, ds32 = teig.gevd(_t(a.astype(np.float32)))
    np.testing.assert_allclose(ds.numpy(), ds32.numpy(), rtol=1e-5)


def test_delaysum_beamformer():
    rng = np.random.default_rng(3)
    base = rng.normal(size=4100).astype(np.float32)
    x = np.stack([base[32:4032], base[28:4028], base[35:4035],
                  base[30:4030]], axis=-1)[None]
    got = tbf.DelaySum_Beamformer(sampling_rate=16000)(_t(x)).numpy()
    want = _j(jbf.DelaySum_Beamformer(sampling_rate=16000)(
        None, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 4000)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_eigh_in_slices_equals_whole(monkeypatch):
    a = _random_packed(np.random.default_rng(4), batch=(5, 7))
    whole = teig.gevd(_t(a))
    monkeypatch.setattr(teig, "EIGH_BATCH", 4)
    sliced = teig.gevd(_t(a))
    for got, want in zip(sliced, whole):
        assert got.shape == want.shape == (5, 7, 4, 4, 2)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

"""Port parity, speech features: windows, ``STFT`` and ``ISTFT`` (and their
round trip), ``spectral_magnitude``, ``Filterbank``, ``DCT``, ``Deltas``,
``ContextWindow``, ``InputNormalization`` with its state across epochs and
through a state dict, and the ``Fbank``/``MFCC`` lobes, against the JAX
package on the CPU, same numpy inputs, f32."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import features as jlobes
from svt_speechbrain_tpu.processing import features as jfeat

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree)
from svt_speechbrain_tpu_torch.models import features as tlobes
from svt_speechbrain_tpu_torch.processing import features as tfeat
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: summation order only
ATOL = 1e-5
# STFT bins of a unit-variance 400-point frame reach ~40: FFT summation order
STFT_ATOL = 2e-4
# log-mel dB values of order 10-100 (10·log10 of filterbank energies)
DB_ATOL = 1e-4


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_windows():
    for n in (1, 4, 400):
        _close(tfeat.hamming_window(n), jfeat.hamming_window(n))
        _close(tfeat.hann_window(n), jfeat.hann_window(n))


@pytest.mark.parametrize("kw", [
    {}, {"pad_mode": "reflect"}, {"center": False, "normalized_stft": True},
    {"n_fft": 512, "window_fn": "hann"}, {"onesided": False}])
def test_stft_matches_jax(kw):
    kw = dict(kw)
    if kw.get("window_fn") == "hann":
        kw_t = dict(kw, window_fn=tfeat.hann_window)
        kw_j = dict(kw, window_fn=jfeat.hann_window)
    else:
        kw_t = kw_j = kw
    x = _x((2, 3200))
    got = tfeat.STFT(16000, **kw_t)(torch.from_numpy(x))
    want = jfeat.STFT(16000, **kw_j)(None, jnp.asarray(x))
    assert got.shape == want.shape
    _close(got, want, STFT_ATOL)
    if not kw:                                     # (B, T, C) input
        xc = _x((2, 1600, 3), 1)
        _close(tfeat.STFT(16000)(torch.from_numpy(xc)),
               jfeat.STFT(16000)(None, jnp.asarray(xc)), STFT_ATOL)


def test_istft_and_round_trip():
    x = _x((2, 4000))
    spec = jfeat.STFT(16000, n_fft=400)(None, jnp.asarray(x))
    for kw in ({"n_fft": 400}, {"n_fft": 400, "center": False}):
        got = tfeat.ISTFT(16000, **kw)(torch.from_numpy(np.array(spec)),
                                      sig_length=3900)
        want = jfeat.ISTFT(16000, **kw)(None, spec, sig_length=3900)
        _close(got, want)
    back = tfeat.ISTFT(16000, n_fft=400)(
        tfeat.STFT(16000, n_fft=400)(torch.from_numpy(x)), sig_length=4000)
    # the hamming window's overlap-add envelope is exact away from the ends
    _close(back[:, 200:3800], x[:, 200:3800], 1e-4)


@pytest.mark.parametrize("power,log", [(1, False), (0.5, False), (1, True)])
def test_spectral_magnitude(power, log):
    s = _x((2, 5, 7, 2))
    _close(tfeat.spectral_magnitude(torch.from_numpy(s), power, log),
           jfeat.spectral_magnitude(jnp.asarray(s), power, log))


@pytest.mark.parametrize("shape", ["triangular", "rectangular", "gaussian"])
@pytest.mark.parametrize("log_mel", [True, False])
def test_filterbank(shape, log_mel):
    spec = np.abs(_x((2, 9, 201), scale=3.0)) ** 2
    kw = dict(n_mels=24, filter_shape=shape, log_mel=log_mel, f_min=50,
              f_max=7000)
    got = tfeat.Filterbank(**kw)(torch.from_numpy(spec))
    want = jfeat.Filterbank(**kw)(None, jnp.asarray(spec))
    _close(got, want, DB_ATOL if log_mel else 1e-4)
    if shape == "triangular" and log_mel:          # (B, T, F, C)
        spec4 = np.abs(_x((2, 9, 201, 2), 1)) ** 2 * 1e-6   # top_db clamp
        _close(tfeat.Filterbank(**kw)(torch.from_numpy(spec4)),
               jfeat.Filterbank(**kw)(None, jnp.asarray(spec4)), DB_ATOL)


def test_dct_deltas_context():
    x = _x((2, 8, 12))
    x4 = _x((2, 8, 12, 2), 1)
    for ortho in (True, False):
        _close(tfeat.DCT(12, 6, ortho)(torch.from_numpy(x)),
               jfeat.DCT(12, 6, ortho)(None, jnp.asarray(x)))
    _close(tfeat.DCT(12, 6)(torch.from_numpy(x4)),
           jfeat.DCT(12, 6)(None, jnp.asarray(x4)))
    for win in (5, 3, 9):
        _close(tfeat.Deltas(12, win)(torch.from_numpy(x)),
               jfeat.Deltas(12, win)(None, jnp.asarray(x)))
    _close(tfeat.Deltas(12)(torch.from_numpy(x4)),
           jfeat.Deltas(12)(None, jnp.asarray(x4)))
    for left, right in ((5, 5), (2, 0), (0, 3)):
        _close(tfeat.ContextWindow(left, right)(torch.from_numpy(x)),
               jfeat.ContextWindow(left, right)(None, jnp.asarray(x)))
    _close(tfeat.ContextWindow(1, 2)(torch.from_numpy(x4)),
           jfeat.ContextWindow(1, 2)(None, jnp.asarray(x4)))


@pytest.mark.parametrize("norm_type,avg_factor,mean_norm,std_norm", [
    ("sentence", None, True, True), ("batch", None, True, False),
    ("global", None, True, True), ("global", 0.3, False, True)])
def test_input_normalization_over_epochs(norm_type, avg_factor, mean_norm,
                                         std_norm):
    """Four training batches over epochs 0-3 (updates stop at epoch 2 with
    ``update_until_epoch=2``), then evaluation; the state after each batch
    against the JAX state, and through a state dict into a fresh module."""
    kw = dict(norm_type=norm_type, avg_factor=avg_factor,
              mean_norm=mean_norm, std_norm=std_norm, update_until_epoch=2)
    jm, tm = jfeat.InputNormalization(**kw), tfeat.InputNormalization(**kw)
    state = jm.init_state()
    lengths = np.asarray([1.0, 0.6, 0.35], np.float32)
    for epoch in range(4):
        x = _x((3, 10, 5), epoch, scale=1 + epoch) + epoch
        want, state = jm(None, state, jnp.asarray(x), jnp.asarray(lengths),
                         epoch=epoch)
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths), epoch=epoch)
        _close(got, want, 1e-4)
        if norm_type == "global":
            _close(tm.glob_mean, state["glob_mean"])
            _close(tm.glob_std, state["glob_std"])
            assert float(tm.count) == float(state["count"]) == epoch + 1
    x = _x((3, 10, 5), 9)
    want, _ = jm(None, state, jnp.asarray(x), jnp.asarray(lengths),
                 train=False)
    _close(tm(torch.from_numpy(x), torch.from_numpy(lengths), train=False),
           want, 1e-4)
    fresh = tfeat.InputNormalization(**kw)
    fresh.load_state_dict(tm.state_dict())
    _close(fresh(torch.from_numpy(x), torch.from_numpy(lengths), train=False),
           want, 1e-4)
    if norm_type == "global":                     # the JAX state tree both ways
        tree = module_tree(tm, running_stats=True)
        other = tfeat.InputNormalization(**kw)
        load_module_tree(other, {}, tree)
        assert torch.equal(other.glob_std, tm.glob_std)


def test_speaker_normalization_and_its_extra_state():
    jm, tm = (jfeat.InputNormalization(norm_type="speaker"),
              tfeat.InputNormalization(norm_type="speaker"))
    state = jm.init_state()
    spk = np.asarray([3, 5, 3])
    for step in range(2):
        x = _x((3, 6, 4), step)
        want, state = jm(None, state, jnp.asarray(x), spk_ids=spk)
        _close(tm(torch.from_numpy(x), spk_ids=spk), want, 1e-4)
    fresh = tfeat.InputNormalization(norm_type="speaker")
    fresh.load_state_dict(tm.state_dict())
    x = _x((3, 6, 4), 7)
    want, _ = jm(None, state, jnp.asarray(x), spk_ids=np.asarray([5, 3, 9]),
                 train=False)
    _close(fresh(torch.from_numpy(x), spk_ids=np.asarray([5, 3, 9]),
                 train=False), want, 1e-4)


@pytest.mark.parametrize("kw", [{}, {"deltas": True, "context": True,
                                     "n_mels": 20, "left_frames": 2,
                                     "right_frames": 1}])
def test_fbank_and_mfcc_lobes(kw):
    wav = _x((2, 4000), scale=0.1)
    _close(tlobes.Fbank(**kw)(torch.from_numpy(wav)),
           jlobes.Fbank(**kw)(None, jnp.asarray(wav)), DB_ATOL)
    mkw = {k: v for k, v in kw.items() if k != "n_mels"}
    # DCT of dB values of order 100: MFCCs of order 100 to 1000
    _close(tlobes.MFCC(**mkw)(torch.from_numpy(wav)),
           jlobes.MFCC(**mkw)(None, jnp.asarray(wav)), 1e-3)

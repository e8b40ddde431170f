"""Port parity, ``processing/signal_processing.py``: each of the ten
functions against the JAX function on the same numpy inputs, f32 on the
CPU.

Tolerances: 1e-6 relative and 1e-6 absolute for the elementwise and
reduction functions (f32 sums in other orders); 2e-5 absolute for the FFT
and convolution paths (f32 transforms of another library); the notch
filter exactly (both build it in numpy); ``dB_to_amplitude`` exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svt_speechbrain_tpu.processing import signal_processing as jsp

from svt_speechbrain_tpu_torch.processing import signal_processing as sp

RTOL = ATOL = 1e-6
FFT_ATOL = 2e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("shape", [(50,), (3, 50), (3, 50, 2)])
@pytest.mark.parametrize("amp_type,scale", [("avg", "linear"),
                                            ("peak", "linear"),
                                            ("avg", "dB"), ("peak", "dB")])
def test_compute_amplitude(shape, amp_type, scale):
    x = _rand(0, *shape)
    x[..., :5] *= 0.0
    _close(sp.compute_amplitude(T(x), amp_type=amp_type, scale=scale),
           jsp.compute_amplitude(J(x), amp_type=amp_type, scale=scale))
    if amp_type == "avg" and len(shape) > 1:
        lengths = np.asarray([[50.0], [30.0], [10.0]], np.float32)
        if len(shape) == 3:
            lengths = lengths[..., None]
        _close(sp.compute_amplitude(T(x), T(lengths), scale=scale),
               jsp.compute_amplitude(J(x), J(lengths), scale=scale))


def test_compute_amplitude_of_silence_in_db_is_floored():
    got = sp.compute_amplitude(torch.zeros(2, 8), scale="dB")
    assert got.tolist() == [[-80.0], [-80.0]]


@pytest.mark.parametrize("snr", [-10, 0, 7.5, np.float32(3.0)])
def test_dB_to_amplitude(snr):
    assert sp.dB_to_amplitude(snr) == jsp.dB_to_amplitude(snr)
    _close(sp.dB_to_amplitude(torch.tensor([snr, 1.0])),
           jsp.dB_to_amplitude(jnp.asarray([snr, 1.0])))


@pytest.mark.parametrize("shape", [(40,), (3, 40)])
@pytest.mark.parametrize("amp_type", ["avg", "peak"])
def test_normalize(shape, amp_type):
    x = _rand(1, *shape)
    _close(sp.normalize(T(x), amp_type=amp_type),
           jsp.normalize(J(x), amp_type=amp_type))


@pytest.mark.parametrize("shape", [(40,), (3, 40)])
@pytest.mark.parametrize("scale,level", [("linear", 0.3), ("dB", -12.0)])
def test_rescale(shape, scale, level):
    x = _rand(2, *shape)
    _close(sp.rescale(T(x), 40, level, scale=scale),
           jsp.rescale(J(x), 40, level, scale=scale))


@pytest.mark.parametrize("kwargs", [
    dict(padding=2), dict(padding=(3, 1), pad_type="reflect"),
    dict(padding=(2, 2), pad_type="edge"), dict(stride=2),
    dict(groups=2), dict(use_fft=True, rotation_index=3),
    dict(use_fft=True, rotation_index=0)])
def test_convolve1d(kwargs):
    x = _rand(3, 2, 60, 4)
    groups = kwargs.get("groups", 1)
    kernel = _rand(4, 4, 7, 4 // groups)
    if kwargs.get("use_fft"):                 # the reverberation layout
        x, kernel = x[..., :1], kernel[:1, :, :1]
    _close(sp.convolve1d(T(x), T(kernel), **kwargs),
           jsp.convolve1d(J(x), J(kernel), **kwargs), atol=FFT_ATOL)


def test_convolve1d_fft_with_a_kernel_longer_than_the_signal():
    x, kernel = _rand(5, 1, 20, 1), _rand(6, 1, 30, 1)
    _close(sp.convolve1d(T(x), T(kernel), use_fft=True, rotation_index=4),
           jsp.convolve1d(J(x), J(kernel), use_fft=True, rotation_index=4),
           atol=FFT_ATOL)


@pytest.mark.parametrize("shape", [(400,), (2, 400), (2, 400, 1)])
def test_reverberate(shape):
    x = _rand(7, *shape)
    rir = np.exp(-np.arange(64) / 8.0).astype(np.float32) * _rand(8, 64)
    rir[5] = 3.0                           # the peak that fixes the rotation
    _close(sp.reverberate(T(x), T(rir)), jsp.reverberate(J(x), J(rir)),
           atol=FFT_ATOL)


@pytest.mark.parametrize("freq,width", [(0.25, 101), (1.0, 31), (0.05, 11)])
def test_notch_filter(freq, width):
    got = sp.notch_filter(freq, width, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (1, width, 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsp.notch_filter(freq, width)))


@pytest.mark.parametrize("frames,length,step", [(6, 8, 4), (5, 6, 4),
                                                (4, 5, 5), (3, 2, 7)])
def test_overlap_and_add(frames, length, step):
    x = _rand(9, 2, frames, length)
    _close(sp.overlap_and_add(T(x), step), jsp.overlap_and_add(J(x), step))


@pytest.mark.parametrize("snr", [-10, -5, 0, 5, 10])
@pytest.mark.parametrize("noise_dims", [1, 2])
def test_mix_at_snr(snr, noise_dims):
    clean, noise = _rand(10, 16000) * 0.1, _rand(11, 16000)
    if noise_dims == 2:
        noise = noise[None]
    _close(sp.mix_at_snr(T(clean), T(noise), snr),
           jsp.mix_at_snr(J(clean), J(noise), snr))
    batch = np.stack([clean, clean * 2])
    _close(sp.mix_at_snr(T(batch), T(np.stack([noise.ravel()] * 2)), snr),
           jsp.mix_at_snr(J(batch), J(np.stack([noise.ravel()] * 2)), snr))


def _frames(x, n=32, hop=16):
    starts = range(0, x.shape[1] - n + 1, hop)
    return np.stack([x[:, s:s + n] for s in starts], 1)


@pytest.mark.parametrize("normalize_wavs", [True, False])
def test_resynthesize(normalize_wavs):
    """A numpy STFT (frames of 32, hop 16, rfft) and its overlap-add
    inverse, called by each package with its own convention."""
    def stft(x):
        spec = np.fft.rfft(_frames(np.asarray(x, np.float64)), axis=-1)
        return np.stack([spec.real, spec.imag], -1).astype(np.float32)

    def istft(c, sig_length):
        c = np.asarray(c, np.float64)
        frames = np.fft.irfft(c[..., 0] + 1j * c[..., 1], n=32, axis=-1)
        out = np.zeros((c.shape[0], sig_length))
        for i in range(frames.shape[1]):
            out[:, i * 16:i * 16 + 32] += frames[:, i]
        return out.astype(np.float32)

    noisy = _rand(12, 2, 160)
    mag = np.abs(_rand(13, 2, 9, 17))
    got = sp.resynthesize(
        T(mag), T(noisy), lambda x: T(stft(x.numpy())),
        lambda c, sig_length: T(istft(c.numpy(), sig_length)),
        normalize_wavs=normalize_wavs)
    want = jsp.resynthesize(
        J(mag), J(noisy), lambda p, x: J(stft(x)),
        lambda p, c, sig_length: J(istft(c, sig_length)),
        normalize_wavs=normalize_wavs)
    assert got.shape == (2, 160)
    _close(got, want, atol=FFT_ATOL)


def test_module_examples_pass():
    import doctest

    result = doctest.testmod(sp, optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0

"""Port parity, augmentation and the STOI loss: ``Resample`` (lengths by
the tick rule, values), every waveform augmenter's apply on the JAX
module's own draws (the key splits recomputed here), the chains
``TimeDomainSpecAugment`` and ``EnvCorrupt``, ``SpecAugment`` through its
deterministic cores and on the JAX draws, and ``stoi_loss``, against the
JAX package on the CPU, f32; and each draw's granularity and range from
the port's generators over many seeds."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import augment as jaug
from svt_speechbrain_tpu.nnet.loss import stoi_loss as jstoi
from svt_speechbrain_tpu.processing import speech_augmentation as jsa

from svt_speechbrain_tpu_torch.dataio.dataio import write_audio
from svt_speechbrain_tpu_torch.models import augment as taug
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from svt_speechbrain_tpu_torch.nnet.loss import stoi_loss as tstoi
from svt_speechbrain_tpu_torch.processing import speech_augmentation as tsa
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, waveforms of order 1: a product or a 101-tap
# convolution in another order; the resampler's taps sum ~14-40 products
ATOL = 1e-5
B, T = 3, 1600


def _wav(seed=0, b=B, t=T, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(b, t)) * scale).astype(
        np.float32)


LENS = np.array([1.0, 0.8, 0.55], np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("orig,new", [(16000, 15200), (16000, 16800),
                                      (16000, 8000), (44100, 16000)])
def test_resample(orig, new):
    x = _wav(1, 2, 4410)
    want = np.asarray(jsa.Resample(orig, new)(None, jnp.asarray(x)))
    got = tsa.Resample(orig, new)(_t(x))
    assert got.shape == want.shape
    # within 1e-6 of the signal's peak
    _close(got, want, atol=1e-6 * np.abs(x).max())
    # (B, T, C) too, and the tick rule's length at every input length
    x3 = np.stack([x, 2 * x], axis=-1)
    _close(tsa.Resample(orig, new)(_t(x3)),
           jsa.Resample(orig, new)(None, jnp.asarray(x3)),
           atol=2e-6 * np.abs(x).max())
    jr, tr = jsa.Resample(orig, new), tsa.Resample(orig, new)
    for n in (0, 1, 7, 160, 441, 999):
        assert tr._output_samples(n) == jr._output_samples(n)


def test_speed_perturb_on_the_jax_draws():
    x = _wav()
    jm = jsa.SpeedPerturb(16000, speeds=[90, 100, 110], perturb_prob=0.7)
    tm = tsa.SpeedPerturb(16000, speeds=[90, 100, 110], perturb_prob=0.7)
    seen = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        draws = {"speed": _t(jax.random.randint(k1, (), 0, 3)),
                 "keep": _t(jax.random.uniform(k2, ()))}
        seen.add((int(draws["speed"]), float(draws["keep"]) > 0.7))
        _close(tm.apply(_t(x), draws), jm(None, jnp.asarray(x), rng=key))
    assert len({s for s, _ in seen}) > 1
    # cut or zero-padded to the input length, never resized
    slow = tsa.SpeedPerturb(16000, speeds=[90])
    out = slow.apply(_t(x), {"speed": torch.tensor(0),
                             "keep": torch.tensor(0.0)})
    assert out.shape == x.shape and float(out[:, -100:].abs().max()) == 0.0


def test_add_babble_on_the_jax_draws():
    x = _wav()
    jm = jsa.AddBabble(speaker_count=2, snr_low=0, snr_high=10, mix_prob=0.6)
    tm = tsa.AddBabble(speaker_count=2, snr_low=0, snr_high=10, mix_prob=0.6)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        draws = {"snr": _t(jax.random.uniform(k1, (B, 1), minval=0,
                                              maxval=10)),
                 "keep": _t(jax.random.uniform(k2, (B, 1)))}
        _close(tm.apply(_t(x), _t(LENS), draws),
               jm(None, jnp.asarray(x), jnp.asarray(LENS), rng=key))


def _drop_freq_draws(key, low, high, f_low, f_high):
    keys = jax.random.split(key, high + 2)
    return {"drop": _t(jax.random.uniform(keys[-1], ())),
            "count": _t(jax.random.randint(keys[0], (), low, high + 1)),
            "freqs": _t(np.array([jax.random.uniform(
                keys[i + 1], (), minval=f_low, maxval=f_high)
                for i in range(high)], np.float32))}


@pytest.mark.parametrize("shape", [(B, T), (B, T, 1)])
def test_drop_freq_on_the_jax_draws(shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    kw = dict(drop_count_low=0, drop_count_high=3, drop_prob=0.8)
    jm, tm = jsa.DropFreq(**kw), tsa.DropFreq(**kw)
    counts = set()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        draws = _drop_freq_draws(key, 0, 3, 1e-14, 1)
        counts.add(int(draws["count"]))
        _close(tm.apply(_t(x), draws), jm(None, jnp.asarray(x), rng=key))
    assert len(counts) > 1


def _drop_chunk_draws(key, b, shape, kw):
    keys = jax.random.split(key, 4)
    lengths, starts = [], []
    for i in range(kw["drop_count_high"]):
        k_len, k_start = jax.random.split(jax.random.fold_in(keys[1], i))
        lengths.append(jax.random.randint(k_len, (b,), kw["drop_length_low"],
                                          kw["drop_length_high"] + 1))
        starts.append(jax.random.uniform(k_start, (b,)))
    return {"counts": _t(jax.random.randint(keys[0], (b,),
                                            kw["drop_count_low"],
                                            kw["drop_count_high"] + 1)),
            "lengths": _t(np.stack(lengths)), "starts": _t(np.stack(starts)),
            "noise": _t(jax.random.uniform(keys[2], shape, minval=-1,
                                           maxval=1)),
            "keep": _t(jax.random.uniform(keys[3], (b, 1)))}


@pytest.mark.parametrize("kw", [
    dict(drop_length_low=50, drop_length_high=300, drop_count_low=0,
         drop_count_high=4, drop_prob=0.8),
    dict(drop_length_low=20, drop_length_high=100, drop_count_low=1,
         drop_count_high=3, drop_start=100, drop_end=-200, noise_factor=0.5),
])
def test_drop_chunk_on_the_jax_draws(kw):
    x = _wav(3)
    jm, tm = jsa.DropChunk(**kw), tsa.DropChunk(**kw)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        draws = _drop_chunk_draws(key, B, x.shape, kw)
        _close(tm.apply(_t(x), _t(LENS), draws),
               jm(None, jnp.asarray(x), jnp.asarray(LENS), rng=key))


def test_do_clip_on_the_jax_draws():
    x = _wav(4, scale=1.0)
    jm = jsa.DoClip(clip_low=0.2, clip_high=0.9, clip_prob=0.5)
    tm = tsa.DoClip(clip_low=0.2, clip_high=0.9, clip_prob=0.5)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        draws = {"clip": _t(jax.random.uniform(k1, (), minval=0.2,
                                               maxval=0.9)),
                 "keep": _t(jax.random.uniform(k2, ()))}
        _close(tm.apply(_t(x), draws), jm(None, jnp.asarray(x), rng=key))


def _write_corpus(root, lengths, seed, name):
    rng = np.random.default_rng(seed)
    lines = ["ID, duration, wav, wav_format, wav_opts"]
    for i, n in enumerate(lengths):
        path = os.path.join(root, f"{name}{i}.wav")
        sig = (0.2 * rng.normal(size=n)).astype(np.float32)
        if name == "rir":
            sig = sig * np.exp(-np.arange(n) / 40.0)
            sig[0] = 0.9
        write_audio(path, torch.from_numpy(sig), 16000)
        lines.append(f"{name}{i}, {n / 16000}, {path}, wav, ")
    csv = os.path.join(root, f"{name}.csv")
    with open(csv, "w") as f:
        f.write("\n".join(lines) + "\n")
    return csv


def _noise_draws(key, b, shape, low, high):
    k_mix, k_snr, k_noise, _ = jax.random.split(key, 4)
    return {"mix": _t(jax.random.uniform(k_mix, ())),
            "snr": _t(jax.random.uniform(k_snr, (b, 1), minval=low,
                                         maxval=high)),
            "white": _t(jax.random.normal(k_noise, shape)),
            "start_u": torch.tensor(0.0)}


def test_add_noise_white_on_the_jax_draws():
    x = _wav(5)
    kw = dict(snr_low=-5, snr_high=10, mix_prob=0.6)
    jm, tm = jsa.AddNoise(**kw), tsa.AddNoise(**kw)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        _close(tm.apply(_t(x), _t(LENS), _noise_draws(key, B, x.shape, -5,
                                                      10)),
               jm(None, jnp.asarray(x), jnp.asarray(LENS), rng=key))
    # normalize: the peak is brought under 1
    loud = tsa.AddNoise(snr_low=0, snr_high=0, normalize=True)
    out = loud(_t(_wav(5, scale=3.0)), rng=torch.Generator().manual_seed(0))
    assert float(out.abs().max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("pad_noise,start_index", [(False, 50), (True, 30),
                                                   (False, None)])
def test_add_noise_corpus_on_the_jax_draws(tmp_path, pad_noise, start_index):
    x = _wav(6)
    # corpus rows shorter than the speech exercise the looping
    lengths = (1200, 900, 1000) if pad_noise else (2200, 2400, 2000, 2600)
    csv = _write_corpus(str(tmp_path), lengths, 7, "noise")
    kw = dict(csv_file=csv, sorting="original", snr_low=0, snr_high=10,
              pad_noise=pad_noise, start_index=start_index)
    jm, tm = jsa.AddNoise(**kw), tsa.AddNoise(**kw)
    for seed in range(2):                       # two batches: the loop
        key = jax.random.PRNGKey(seed)
        draws = _noise_draws(key, B, x.shape, 0, 10)
        if start_index is None:
            # the JAX start: randint(0, max_chop) over the sorted corpus
            noise_len = np.sort(lengths)[:B] if seed == 0 else np.sort(
                lengths)[[3, 0, 1]]
            abs_len = (LENS * T).astype(np.int64)
            max_chop = max(int((noise_len - abs_len).min()), 1)
            draws["start"] = int(jax.random.randint(
                jax.random.split(key, 4)[3], (), 0, max_chop))
        _close(tm.apply(_t(x), _t(LENS), draws),
               jm(None, jnp.asarray(x), jnp.asarray(LENS), rng=key),
               atol=2e-5)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_add_reverb_on_the_jax_draws(tmp_path, scale):
    x = _wav(8)
    csv = _write_corpus(str(tmp_path), (200, 300), 9, "rir")
    kw = dict(csv_file=csv, sorting="original", reverb_prob=0.8,
              rir_scale_factor=scale)
    jm, tm = jsa.AddReverb(**kw), tsa.AddReverb(**kw)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        draws = {"reverb": _t(jax.random.uniform(jax.random.split(key)[1],
                                                 ()))}
        _close(tm.apply(_t(x), draws), jm(None, jnp.asarray(x), rng=key))
    rir = (np.exp(-np.arange(64) / 8.0) * np.cos(np.arange(64))).astype(
        np.float32)
    jf = jsa.AddReverb(rir_funct=lambda key: rir)
    tf = tsa.AddReverb(rir_funct=lambda gen: torch.from_numpy(rir))
    key = jax.random.PRNGKey(3)
    _close(tf.apply(_t(x), {"reverb": torch.tensor(0.0), "generator": None}),
           jf(None, jnp.asarray(x), rng=key))


def test_time_domain_spec_augment_on_the_jax_draws():
    x = _wav(10)
    kw = dict(speeds=[95, 100, 105], drop_freq_count_low=1,
              drop_freq_count_high=2, drop_chunk_count_low=1,
              drop_chunk_count_high=3, drop_chunk_length_low=30,
              drop_chunk_length_high=90)
    jm, tm = jaug.TimeDomainSpecAugment(**kw), taug.TimeDomainSpecAugment(
        **kw)
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    s1, s2 = jax.random.split(k1)
    out = tm.speed_perturb.apply(_t(x), {
        "speed": _t(jax.random.randint(s1, (), 0, 3)),
        "keep": _t(jax.random.uniform(s2, ()))})
    out = tm.drop_freq.apply(out, _drop_freq_draws(k2, 1, 2, 1e-14, 1))
    out = tm.drop_chunk.apply(out, _t(LENS), _drop_chunk_draws(
        k3, B, x.shape, dict(drop_count_low=1, drop_count_high=3,
                             drop_length_low=30, drop_length_high=90)))
    _close(out, jm(None, jnp.asarray(x), jnp.asarray(LENS), rng=key))


def test_env_corrupt_on_the_jax_draws(tmp_path):
    x = _wav(12)
    noise_csv = _write_corpus(str(tmp_path), (2000, 2100, 2200), 13, "noise")
    rir_csv = _write_corpus(str(tmp_path), (150,), 14, "rir")
    kw = dict(noise_snr_low=0, noise_snr_high=10, babble_speaker_count=2,
              babble_snr_low=5, babble_snr_high=15, reverb_csv=rir_csv,
              noise_csv=noise_csv)
    jm, tm = jaug.EnvCorrupt(**kw), taug.EnvCorrupt(**kw)
    for module in (jm.add_reverb, jm.add_noise, tm.add_reverb, tm.add_noise):
        module.sorting = "original"
    key = jax.random.PRNGKey(15)
    k1, k2, k3 = jax.random.split(key, 3)
    out = tm.add_reverb.apply(_t(x), {
        "reverb": _t(jax.random.uniform(jax.random.split(k1)[1], ()))})
    b1, b2 = jax.random.split(k2)
    out = tm.add_babble.apply(out, _t(LENS), {
        "snr": _t(jax.random.uniform(b1, (B, 1), minval=5, maxval=15)),
        "keep": _t(jax.random.uniform(b2, (B, 1)))})
    draws = _noise_draws(k3, B, x.shape, 0, 10)
    noise_len = np.array([2000, 2100, 2200])
    max_chop = max(int((noise_len - (LENS * T).astype(np.int64)).min()), 1)
    draws["start"] = int(jax.random.randint(jax.random.split(k3, 4)[3], (),
                                            0, max_chop))
    out = tm.add_noise.apply(out, _t(LENS), draws)
    _close(out, jm(None, jnp.asarray(x), jnp.asarray(LENS), rng=key),
           atol=2e-5)


@pytest.mark.parametrize("c,w", [(20, 17), (20, 24), (6, 2), (33, 38)])
def test_time_warp_core(c, w):
    x = np.random.default_rng(16).normal(size=(2, 40, 6)).astype(np.float32)
    jm, tm = jaug.SpecAugment(), taug.SpecAugment()
    _close(tm._time_warp_cw(_t(x), c, w),
           jm._time_warp_cw(jnp.asarray(x), c, w))


@pytest.mark.parametrize("zero", [True, False])
def test_mask_core(zero):
    x = np.random.default_rng(17).normal(size=(2, 30, 12)).astype(np.float32)
    jm = jaug.SpecAugment(replace_with_zero=zero)
    tm = taug.SpecAugment(replace_with_zero=zero)
    pos, length = np.array([[3, 10], [0, 25]]), np.array([[4, 0], [2, 5]])
    for dim in (1, 2):
        _close(tm._mask(_t(x), _t(pos), _t(length), dim),
               jm._mask(jnp.asarray(x), pos, length, dim))


def test_spec_augment_on_the_jax_draws():
    x = np.random.default_rng(18).normal(size=(B, 60, 20)).astype(np.float32)
    kw = dict(time_warp_window=5, n_freq_mask=2, freq_mask_width=(0, 6),
              n_time_mask=2, time_mask_width=(0, 10))
    jm, tm = jaug.SpecAugment(**kw), taug.SpecAugment(**kw)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        k_warp, k_f, k_t = jax.random.split(key, 3)
        w1, w2 = jax.random.split(k_warp)
        c = jax.random.randint(w1, (), 5, 55)
        w = jax.random.randint(w2, (), c - 5, c + 5) + 1
        out = tm._time_warp_cw(_t(x), _t(c), _t(w))
        for k, dim, (lo, hi) in ((k_f, 2, (0, 6)), (k_t, 1, (0, 10))):
            k_len, k_pos = jax.random.split(k)
            length = jax.random.randint(k_len, (B, 2), lo, hi)
            pos = jax.random.randint(k_pos, (B, 2), 0, jnp.maximum(
                1, x.shape[dim] - length.max()))
            out = tm._mask(out, _t(pos), _t(length), dim)
        _close(out, jm(None, jnp.asarray(x), rng=key))


def test_draws_keep_the_jax_granularity_and_ranges():
    x = torch.zeros(B, T)
    speeds, counts, widths = set(), set(), set()
    for seed in range(60):
        gen = torch.Generator().manual_seed(seed)
        noise = tsa.AddNoise(snr_low=-3, snr_high=7).draw(x, gen)
        assert noise["mix"].shape == () and noise["snr"].shape == (B, 1)
        assert noise["white"].shape == (B, T)
        assert bool(((noise["snr"] >= -3) & (noise["snr"] < 7)).all())
        sp = tsa.SpeedPerturb(16000, speeds=[90, 100, 110]).draw(gen)
        assert sp["speed"].shape == () and sp["keep"].shape == ()
        speeds.add(int(sp["speed"]))
        bab = tsa.AddBabble().draw(x, gen)
        assert bab["snr"].shape == bab["keep"].shape == (B, 1)
        df = tsa.DropFreq(drop_count_low=1, drop_count_high=3,
                          drop_freq_low=0.1, drop_freq_high=0.6).draw(gen)
        assert df["drop"].shape == () and df["count"].shape == ()
        assert df["freqs"].shape == (3,)
        assert bool(((df["freqs"] >= 0.1) & (df["freqs"] < 0.6)).all())
        counts.add(int(df["count"]))
        dc = tsa.DropChunk(drop_length_low=5, drop_length_high=9,
                           drop_count_low=0, drop_count_high=4,
                           noise_factor=0.1).draw(x, gen)
        assert dc["counts"].shape == (B,) and dc["keep"].shape == (B, 1)
        assert dc["lengths"].shape == dc["starts"].shape == (4, B)
        assert dc["noise"].shape == (B, T)
        assert int(dc["counts"].min()) >= 0 and int(dc["counts"].max()) <= 4
        assert int(dc["lengths"].min()) >= 5 and int(dc["lengths"].max()) <= 9
        clip = tsa.DoClip(clip_low=0.3, clip_high=0.4).draw(gen)
        assert clip["clip"].shape == clip["keep"].shape == ()
        assert 0.3 <= float(clip["clip"]) < 0.4
        assert tsa.AddReverb().draw(gen)["reverb"].shape == ()
        spec = taug.SpecAugment(time_warp_window=5)
        c, w = spec.draw_warp(40, gen)
        assert 5 <= int(c) < 35 and int(c) - 5 + 1 <= int(w) <= int(c) + 5
        pos, length = spec.draw_mask(B, 20, 2, (0, 6), gen)
        assert pos.shape == length.shape == (B, 2)
        assert int(pos.max()) < max(1, 20 - int(length.max()))
        widths.update(length.flatten().tolist())
    assert speeds == {0, 1, 2} and counts == {1, 2, 3}
    assert widths == set(range(6))
    assert taug.SpecAugment().draw_warp(10, torch.Generator()) is None


def test_identity_without_a_generator_and_step_rng():
    x = _t(_wav())
    for module in (tsa.AddNoise(), tsa.AddBabble(), tsa.DropChunk(),
                   taug.EnvCorrupt(), taug.TimeDomainSpecAugment()):
        assert module(x, _t(LENS)) is x
    for module in (tsa.DropFreq(), tsa.DoClip(), tsa.SpeedPerturb(16000)):
        assert module(x) is x
    assert taug.SpecAugment()(x[..., None]) is not None
    rng = StepRNG(torch.Generator().manual_seed(0), torch.Generator())
    out = taug.TimeDomainSpecAugment(drop_chunk_length_low=10,
                                     drop_chunk_length_high=20)(x, rng=rng)
    assert out.shape == x.shape and not torch.equal(out, x)


def test_host_reads_are_counted():
    x = _t(_wav())
    gen = torch.Generator().manual_seed(0)
    noise, drop, reverb = tsa.AddNoise(), tsa.DropFreq(), tsa.AddReverb()
    noise(x, rng=gen)                               # the mix gate
    noise(x, rng=gen)
    drop(x, rng=gen)                                # the batch gate
    reverb(x, rng=gen)                              # the batch gate
    assert (noise.host_reads, drop.host_reads, reverb.host_reads) == (2, 1, 1)
    # the speed, the clip and the keep gates stay on the device
    for module in (tsa.SpeedPerturb(16000), tsa.DoClip(), tsa.AddBabble(),
                   tsa.DropChunk()):
        assert not hasattr(module, "host_reads")


def test_stoi_loss():
    # broadband, amplitude-modulated noise as the clean signal: every
    # third-octave band holds energy (a pure tone leaves most bands at the
    # sqrt(1e-14) floor, where the envelope normalization turns rounding
    # into differences of 1e-4 between any two implementations)
    rng = np.random.default_rng(19)
    t = 16000
    envelope = 0.6 + 0.4 * np.sin(np.arange(t) * 2 * np.pi * 4 / t)
    clean = (rng.normal(size=(2, t)) * envelope * 0.3).astype(np.float32)
    clean[:, 4000:6000] = 0.0                        # silence to remove
    noisy = (clean + 0.05 * rng.normal(size=clean.shape)).astype(np.float32)
    lens = np.array([1.0, 0.8], np.float32)
    for reduction in ("mean", "batch"):
        want = np.asarray(jstoi.stoi_loss(jnp.asarray(noisy),
                                          jnp.asarray(clean),
                                          jnp.asarray(lens),
                                          reduction=reduction))
        got = tstoi.stoi_loss(_t(noisy)[..., None], _t(clean), _t(lens),
                              reduction=reduction)
        _close(got, want)
    obm, cf = tstoi.thirdoct(10000, 512, 15, 150)
    jobm, jcf = jstoi.thirdoct(10000, 512, 15, 150)
    np.testing.assert_array_equal(obm, jobm)
    np.testing.assert_array_equal(cf, jcf)
    xs, ys = tstoi.removeSilentFrames(_t(clean[0]), _t(noisy[0]))
    jxs, jys = jstoi.removeSilentFrames(clean[0], noisy[0])
    _close(xs, jxs)
    _close(ys, jys)
    # the loss is differentiable in the enhanced signal
    pred = _t(noisy).clone().requires_grad_()
    tstoi.stoi_loss(pred, _t(clean)).backward()
    assert torch.isfinite(pred.grad).all() and float(pred.grad.abs().max()) > 0

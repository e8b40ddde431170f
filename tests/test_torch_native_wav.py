"""The port's WAV reader against the JAX package's, bit for bit: 8, 16, 24
and 32-bit PCM and 32-bit float files, mono and stereo, whole and sliced,
through the native C++ decoder and with ``SVT_NATIVE=0`` (scipy); the
native library built from the port's own source into ``build/native/``;
``read_audio_multichannel`` and ``native.wav_read_int16``."""
import os
import wave

import numpy as np
import pytest

from svt_speechbrain_tpu.dataio import dataio as jdataio
from svt_speechbrain_tpu import native as jnative

from svt_speechbrain_tpu_torch import native
from svt_speechbrain_tpu_torch.dataio import dataio

SR = 16000
FORMATS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32"]


def _write(path, kind, channels, seed):
    """A seeded noise file of 1001 frames in ``kind``."""
    rng = np.random.default_rng(seed)
    sig = np.clip(0.4 * rng.standard_normal((1001, channels)), -1, 1)
    if kind == "float32":
        from scipy.io import wavfile
        wavfile.write(path, SR, sig.astype(np.float32).squeeze())
        return
    width = int(kind[3:]) // 8
    full = 2 ** (8 * width - 1)
    pcm = np.round(sig * (full - 1)).astype(np.int64)
    if width == 1:
        raw = (pcm + 128).astype(np.uint8).tobytes()
    else:
        raw = pcm.astype("<i8").view(np.uint8).reshape(-1, 8)[:, :width]
        raw = raw.tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(SR)
        w.writeframes(raw)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    out = {}
    for i, kind in enumerate(FORMATS):
        for channels in (1, 2):
            path = str(root / f"{kind}_{channels}.wav")
            _write(path, kind, channels, seed=10 * i + channels)
            out[(kind, channels)] = path
    return out


def test_the_native_library_builds_from_the_port_source():
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    # a copy of the JAX package's decoder: the code lines are the same
    def code(text):
        return [line for line in text.splitlines()
                if not line.lstrip().startswith("//")]

    theirs = os.path.join(os.path.dirname(jnative.__file__),
                          "wav_loader.cpp")
    assert native.SRC.parent == path.parents[2] / "svt_speechbrain_tpu_torch" \
        / "native"
    with open(theirs) as f:
        assert code(native.SRC.read_text()) == code(f.read())


@pytest.mark.parametrize("use_native", ["1", "0"])
@pytest.mark.parametrize("kind", FORMATS)
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_jax_bit_for_bit(wavs, monkeypatch, use_native,
                                          kind, channels):
    monkeypatch.setenv("SVT_NATIVE", use_native)
    path = wavs[(kind, channels)]
    for start, stop in ((0, None), (17, 530), (990, 5000), (0, 1001)):
        got, sr = dataio._read_wav(path, start=start, stop=stop)
        want, jsr = jdataio._read_wav(path, start=start, stop=stop)
        assert sr == jsr == SR
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        assert np.array_equal(got, want)
    got = dataio.read_audio({"file": path, "start": 5, "stop": 99})
    assert np.array_equal(got, jdataio.read_audio(
        {"file": path, "start": 5, "stop": 99}))


def test_native_reads_are_the_native_library_s(wavs, monkeypatch):
    """With the library the read is the native decoder's, sliced in the
    file; ``wav_read_int16`` mixes to mono as the JAX package's does."""
    monkeypatch.setenv("SVT_NATIVE", "1")
    path = wavs[("pcm16", 2)]
    got, _ = dataio._read_wav(path, 100, 200)
    want, _ = native.wav_read(path, 100, 200)
    assert np.array_equal(got, want) and got.shape == (100, 2)
    assert native.wav_info(path) == jnative.wav_info(path)
    mono, sr = native.wav_read_int16(path, 3, 900)
    jmono, jsr = jnative.wav_read_int16(path, 3, 900)
    assert sr == jsr and mono.dtype == np.int16
    assert np.array_equal(mono, jmono)
    assert native.wav_read_int16(wavs[("float32", 1)]) is None
    assert native.wav_read(path + ".missing") is None


def test_read_audio_multichannel_matches_jax(wavs, monkeypatch):
    monkeypatch.setenv("SVT_NATIVE", "1")
    obj = {"files": [wavs[("pcm16", 1)], wavs[("pcm24", 2)]], "start": 7,
           "stop": 400}
    got = dataio.read_audio_multichannel(obj)
    assert got.shape == (393, 3)
    assert np.array_equal(got, jdataio.read_audio_multichannel(obj))
    one = wavs[("float32", 2)]
    assert np.array_equal(dataio.read_audio_multichannel(one),
                          jdataio.read_audio_multichannel(one))

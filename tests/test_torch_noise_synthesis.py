"""Port parity, the noisy sets: the port's ``synthesis_noise`` (accomp,
white, babble, natural) and ``prepare_musan`` against the JAX recipe
scripts on one small synthetic folder, after ``tests/test_noise_synthesis.py``.

Held: the same files under the same names; every noise draw bit for bit
(each script's noise as it enters the mix, and the written ``noise.wav``
and ``babble.json``); every ``SNR_<x>dB.wav`` within 1 int16 step of the
JAX script's (the mix is f32 in both, summed in other orders, so a sample
on a rounding boundary may land one step apart); ``prepare_musan``'s clips,
babble and count exactly (numpy on both sides)."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from svt_speechbrain_tpu.dataio.dataio import write_audio

from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual import (
    prepare_musan, synthesis_noise)
from tests.conftest import REPO_ROOT

JAX_AV = os.path.join(REPO_ROOT, "recipes", "N20EMv2", "audio_visual")
SR = 16000
LSB = 1


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(JAX_AV, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"jax_{name}"] = mod
    spec.loader.exec_module(mod)
    return mod


def _make_set(root):
    """3 songs (train, valid, test) of 2.5, 3.2 and 1.7 s, each with a
    vocal and an accompaniment stem; babble clips of exactly 1 s named by
    split, and natural clips of 0.3-1 s, one folder down."""
    rng = np.random.default_rng(5)
    annotations = {}
    for i, (split, seconds) in enumerate((("train", 2.5), ("valid", 3.2),
                                          ("test", 1.7))):
        entry = f"song{i}"
        annotations[entry] = {"midi": [[0.2, 0.5, 60]], "split": split}
        d = os.path.join(root, "data", entry)
        os.makedirs(d)
        n = int(seconds * SR)
        write_audio(os.path.join(d, "vocals.wav"),
                    rng.normal(size=n).astype(np.float32) * 0.1, SR)
        write_audio(os.path.join(d, "accomp.wav"),
                    rng.normal(size=n).astype(np.float32) * 0.2, SR)
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump(annotations, f)
    babble = os.path.join(root, "noise", "babble", "mix")
    natural = os.path.join(root, "noise", "natural")
    os.makedirs(babble)
    for m, split in enumerate(["train", "train", "valid", "test", "test"]):
        write_audio(os.path.join(babble, f"{split}-babble-{m}.wav"),
                    rng.normal(size=SR).astype(np.float32) * 0.3, SR)
    for source in ("free-sound", "sound-bible"):
        os.makedirs(os.path.join(natural, source))
        for k in range(4):
            n = int(rng.integers(SR * 3 // 10, SR))
            write_audio(os.path.join(natural, source, f"noise-{k}.wav"),
                        rng.normal(size=n).astype(np.float32) * 0.2, SR)


def _run(module, root, kind, record, device):
    """``kind``'s synthesis of ``module`` on ``root``, with each noise that
    enters the mix recorded."""
    original = module._save_snr_sweep

    def recording(out_dir, audio, noise, *rest):
        record.append((os.path.relpath(out_dir, root), np.array(noise)))
        return original(out_dir, audio, noise, *rest)

    module._save_snr_sweep = recording
    extra = {} if device is None else {"device": device}
    try:
        noise = os.path.join(root, "noise")
        if kind == "accomp":
            module.synthesis_accomp(root, **extra)
        elif kind == "white":
            module.synthesis_white(root, **extra)
        elif kind == "babble":
            module.synthesis_babble(
                root, os.path.join(noise, "babble"),
                save_json_file=os.path.join(root, "babble.json"),
                duration_thrd=1, **extra)
        else:
            module.synthesis_natural(root, os.path.join(noise, "natural"),
                                     duration_thrd=1, **extra)
    finally:
        module._save_snr_sweep = original


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.mark.parametrize("kind", ["accomp", "white", "babble", "natural"])
def test_noisy_sets_match_the_jax_script(tmp_path, kind):
    roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    records = {"jax": [], "port": []}
    for side, root in roots.items():
        _make_set(root)
        if side == "jax":
            _run(_load("synthesis_noise"), root, kind, records[side], None)
        else:
            _run(synthesis_noise, root, kind, records[side], "cpu")

    assert [r[0] for r in records["port"]] == [r[0] for r in records["jax"]]
    assert len(records["port"]) == 3
    for (_, got), (_, want) in zip(records["port"], records["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    want_files, got_files = _files(roots["jax"]), _files(roots["port"])
    assert sorted(got_files) == sorted(want_files)
    written = [k for k in want_files if "noise_data" in k]
    assert len(written) == 3 * (5 + (kind in ("babble", "natural")))
    worst = 0
    for rel, want_path in want_files.items():
        got_path = got_files[rel]
        if rel.endswith(".json"):
            assert open(got_path).read() == open(want_path).read().replace(
                roots["jax"], roots["port"])
            continue
        _, want = wavfile.read(want_path)
        _, got = wavfile.read(got_path)
        assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
        if "SNR_" not in rel:                  # inputs and noise.wav
            np.testing.assert_array_equal(got, want, err_msg=rel)
            continue
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        worst = max(worst, int(diff))
    assert worst <= LSB, worst


def test_synthesis_runs_on_cuda_unless_told(tmp_path, monkeypatch):
    """Without a device named the synthesis asks for CUDA, as every entry
    point of the port does; here, without a card, that raises."""
    import torch

    _make_set(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesis_noise.synthesis_white(str(tmp_path))


def _musan(root):
    """A MUSAN-shaped folder: ``speech/<source>/*.wav`` and
    ``music/<source>/*.wav``, one of them at 8 kHz and one in stereo."""
    rng = np.random.default_rng(6)
    for kind, source, name, seconds, rate, channels in (
            ("speech", "librivox", "a", 2.5, SR, 1),
            ("speech", "librivox", "b", 1.2, SR, 1),
            ("speech", "us-gov", "c", 3.0, 8000, 1),
            ("music", "fma", "d", 2.2, SR, 2)):
        d = os.path.join(root, kind, source)
        os.makedirs(d, exist_ok=True)
        audio = rng.normal(size=(int(seconds * rate), channels)) * 0.2
        write_audio(os.path.join(d, f"{name}.wav"),
                    audio.astype(np.float32), rate)


def test_prepare_musan_matches_the_jax_script(tmp_path):
    jax_musan = _load("prepare_musan")
    out = {}
    for side, module in (("jax", jax_musan), ("port", prepare_musan)):
        root = tmp_path / side
        _musan(str(root / "musan"))
        for shard in (0, 1):
            module.split_musan(str(root / "musan"), str(root / "clips"),
                               clip_seconds=1, shard=shard, nshards=2)
        module.make_musan_babble(str(root / "musan" / "speech"),
                                 str(root / "babble"), n_speakers=2,
                                 n_mixes=8, clip_seconds=1, seed=3)
        out[side] = (root, module.count_frames(str(root / "clips")))
    (jroot, jcount), (proot, pcount) = out["jax"], out["port"]
    assert pcount == jcount > 0
    for folder in ("clips", "babble"):
        want, got = _files(jroot / folder), _files(proot / folder)
        assert sorted(got) == sorted(want) and len(got) > 0
        for rel in want:
            np.testing.assert_array_equal(wavfile.read(got[rel])[1],
                                          wavfile.read(want[rel])[1])
    assert sorted(_files(proot / "babble")) == sorted(
        f"{s}-babble-{m}.wav" for m, s in enumerate(
            ["train"] * 6 + ["valid"] + ["test"]))

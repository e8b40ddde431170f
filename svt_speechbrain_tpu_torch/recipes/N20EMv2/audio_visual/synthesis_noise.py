#!/usr/bin/env python3
"""Noise synthesis for the robustness sweep (port of
``recipes/N20EMv2/audio_visual/synthesis_noise.py``).

Writes each song's ``noise_data/<type>/SNR_{-10,-5,0,5,10}dB.wav`` for four
noise types:

- ``accomp``: the song's accompaniment stem, ``accomp.wav``;
- ``white``: Gaussian noise from ``numpy.random.default_rng(seed)``;
- ``babble``: the 10 s MUSAN babble clips of ``prepare_musan.py``, tiled
  (each centred in its window) to the song's length;
- ``natural``: MUSAN's free-sound and sound-bible clips, split 3/4, 1/8,
  1/8 over train, valid and test by their sorted index, tiled as babble.

The mix is ``processing.signal_processing.mix_at_snr`` in float32 on the
chosen device. As in the JAX script, the song's own split chooses its
babble pool, and every draw comes from numpy generators, so the noise is
the JAX script's bit for bit; the written WAVs may differ from its by one
int16 step where a float32 sum rounds the other way.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.synthesis_noise \\
>     --n20emv2 /path/to/N20EMv2 --noise_type accomp
"""
import argparse
import glob
import json
import os

import numpy as np
import torch

from svt_speechbrain_tpu_torch import resolve_device
from svt_speechbrain_tpu_torch.dataio.dataio import _read_wav, write_audio
from svt_speechbrain_tpu_torch.processing.signal_processing import mix_at_snr

SAMPLERATE = 16000
SNRS = (-10, -5, 0, 5, 10)


def _load_mono(path):
    audio, sr = _read_wav(path)
    assert sr == SAMPLERATE and audio.shape[1] == 1, path
    return audio[:, 0]


def _save_snr_sweep(out_dir, audio, noise, device):
    os.makedirs(out_dir, exist_ok=True)
    clean = torch.as_tensor(audio, device=device)
    noise = torch.as_tensor(noise, device=device)
    for snr_db in SNRS:
        mixed = mix_at_snr(clean, noise, snr_db).cpu().numpy()
        write_audio(os.path.join(out_dir, f"SNR_{snr_db}dB.wav"), mixed,
                    SAMPLERATE)


def _songs(folder):
    with open(os.path.join(folder, "annotations.json")) as f:
        annotations = json.load(f)
    return annotations, os.path.join(folder, "data")


def synthesis_accomp(folder, device=None):
    """Accompaniment-stem sweep (``synthesis_noise.py:53``)."""
    device = resolve_device(device)
    annotations, folder_data = _songs(folder)
    for entry in annotations:
        audio = _load_mono(os.path.join(folder_data, entry, "vocals.wav"))
        accomp = _load_mono(os.path.join(folder_data, entry, "accomp.wav"))
        assert len(audio) == len(accomp)
        _save_snr_sweep(os.path.join(folder_data, entry, "noise_data",
                                     "accomp"), audio, accomp, device)


def synthesis_white(folder, seed=0, device=None):
    """White-noise sweep (``synthesis_noise.py:66``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    annotations, folder_data = _songs(folder)
    for entry in annotations:
        audio = _load_mono(os.path.join(folder_data, entry, "vocals.wav"))
        white = rng.standard_normal(len(audio)).astype(np.float32)
        _save_snr_sweep(os.path.join(folder_data, entry, "noise_data",
                                     "white"), audio, white, device)


def _tile_noise(pool, total_len, duration_thrd, rng):
    """Clips of at most ``duration_thrd`` seconds drawn from ``pool``, each
    centred in its window, cut to ``total_len`` samples
    (``synthesis_noise.py:79``)."""
    window = round(SAMPLERATE * duration_thrd)
    n_windows = int(np.ceil(total_len / window))
    pieces = []
    keys = list(pool.keys())
    for w in range(n_windows):
        clip = pool[keys[rng.integers(len(keys))]]
        if w < n_windows - 1:
            assert len(clip) <= window
            pad1 = (window - len(clip)) // 2
            piece = np.zeros(window, np.float32)
            piece[pad1:pad1 + len(clip)] = clip
        else:
            remain = total_len - (n_windows - 1) * window
            if len(clip) <= remain:
                pad1 = (remain - len(clip)) // 2
                piece = np.zeros(remain, np.float32)
                piece[pad1:pad1 + len(clip)] = clip
            else:
                piece = clip[:remain]
        pieces.append(piece)
    noise = np.concatenate(pieces)
    assert len(noise) == total_len
    return noise


def _load_pools_by_split(noise_files, split_fn):
    pools = {"train": {}, "valid": {}, "test": {}}
    for file in noise_files:
        audio, sr = _read_wav(file)
        if sr != SAMPLERATE or audio.shape[1] != 1:
            continue
        split = split_fn(file)
        if split in pools:
            pools[split][file] = audio[:, 0]
    return pools


def _save_tiled(folder, kind, pools, duration_thrd, rng, device):
    annotations, folder_data = _songs(folder)
    for entry in annotations:
        split = annotations[entry].get("split", "train")
        audio = _load_mono(os.path.join(folder_data, entry, "vocals.wav"))
        noise = _tile_noise(pools[split], len(audio), duration_thrd, rng)
        out_dir = os.path.join(folder_data, entry, "noise_data", kind)
        os.makedirs(out_dir, exist_ok=True)
        write_audio(os.path.join(out_dir, "noise.wav"), noise, SAMPLERATE)
        _save_snr_sweep(out_dir, audio, noise, device)


def synthesis_babble(folder, noise_folder, save_json_file="noise/babble.json",
                     duration_thrd=10, seed=0, device=None):
    """MUSAN-babble sweep (``synthesis_noise.py:119``): ``noise_folder``
    holds 10 s clips named ``<split>-*.wav`` one folder down; their list
    goes to ``save_json_file``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    json_data = {}
    for file in sorted(glob.glob(noise_folder + "/*/*wav")):
        noise, sr = _read_wav(file)
        if sr != SAMPLERATE:
            continue
        duration = noise.shape[0] / SAMPLERATE
        if duration == duration_thrd:
            json_data[os.path.basename(file)] = {
                "path": file,
                "split": os.path.basename(file).split("-")[0],
                "duration": duration,
            }
    os.makedirs(os.path.dirname(os.path.abspath(save_json_file)),
                exist_ok=True)
    with open(save_json_file, "w") as f:
        f.write(json.dumps(json_data, indent=2))

    pools = {"train": {}, "valid": {}, "test": {}}
    for entry, meta in json_data.items():
        audio, _ = _read_wav(meta["path"])
        pools[meta["split"]][entry] = audio[:, 0]
    _save_tiled(folder, "babble", pools, duration_thrd, rng, device)


def synthesis_natural(folder, noise_folder, duration_thrd=10, seed=0,
                      device=None):
    """MUSAN natural-noise sweep (``synthesis_noise.py:159``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    noise_files = sorted(glob.glob(noise_folder + "/*/*wav"))

    def split_fn(file):
        idx = noise_files.index(file)
        n = len(noise_files)
        if idx < n * 3 // 4:
            return "train"
        if idx < n * 7 // 8:
            return "valid"
        return "test"

    pools = _load_pools_by_split(noise_files, split_fn)
    _save_tiled(folder, "natural", pools, duration_thrd, rng, device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--n20emv2", type=str, default="/path/to/N20EMv2")
    parser.add_argument("--noise_type", type=str, default="accomp",
                        choices=["accomp", "white", "babble", "natural"])
    parser.add_argument("--musan_babble", type=str, default="noise/babble")
    parser.add_argument("--musan_natural", type=str, default="noise/natural")
    parser.add_argument("--device", type=str, default=None)
    args = parser.parse_args()

    if args.noise_type == "accomp":
        synthesis_accomp(args.n20emv2, device=args.device)
    elif args.noise_type == "white":
        synthesis_white(args.n20emv2, device=args.device)
    elif args.noise_type == "babble":
        synthesis_babble(args.n20emv2, args.musan_babble, device=args.device)
    else:
        synthesis_natural(args.n20emv2, args.musan_natural,
                          device=args.device)

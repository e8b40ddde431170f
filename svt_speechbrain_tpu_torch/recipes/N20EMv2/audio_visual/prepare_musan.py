#!/usr/bin/env python3
"""MUSAN preparation (port of ``recipes/N20EMv2/audio_visual/prepare_musan.py``).

- ``split_musan``: cut MUSAN's WAVs into 10 s clips at 16 kHz mono;
- ``make_musan_babble``: babble clips, each the sum of up to 30 random
  speech clips, peak-normalized to 0.9, named ``<split>-babble-<m>.wav``
  (3/4 train, 1/8 valid, the rest test);
- ``count_frames``: the total sample count under a folder.

``--shard i --nshards n`` splits ``split`` over processes.

Run:
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.prepare_musan \\
>     split --musan /path/to/musan --out ./noise
"""
import argparse
import glob
import os

import numpy as np

from svt_speechbrain_tpu_torch.dataio.dataio import _read_wav, write_audio

SAMPLERATE = 16000


def split_musan(musan_root, out_root, clip_seconds=10, shard=0, nshards=1):
    """``<musan>/<kind>/<source>/<file>.wav`` → ``<out>/<kind>/<source>/
    <kind>-<source>-<file>-<i>.wav``, whole clips only
    (``prepare_musan.py:27``)."""
    files = sorted(glob.glob(os.path.join(musan_root, "*", "*", "*.wav")))
    files = files[shard::nshards]
    window = SAMPLERATE * clip_seconds
    for file in files:
        audio, sr = _read_wav(file)
        if sr != SAMPLERATE:
            from math import gcd

            from scipy.signal import resample_poly

            g = gcd(SAMPLERATE, sr)
            audio = resample_poly(audio, SAMPLERATE // g, sr // g, axis=0)
        audio = audio.mean(axis=1)
        rel = os.path.relpath(file, musan_root)
        stem = os.path.splitext(rel.replace(os.sep, "-"))[0]
        out_dir = os.path.join(out_root, os.path.dirname(rel))
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(audio) // window):
            clip = audio[i * window:(i + 1) * window]
            write_audio(os.path.join(out_dir, f"{stem}-{i}.wav"), clip,
                        SAMPLERATE)


def make_musan_babble(speech_root, out_root, n_speakers=30, n_mixes=100,
                      clip_seconds=10, seed=0):
    """``n_mixes`` babble clips from the speech WAVs under ``speech_root``,
    drawn from ``numpy.random.default_rng(seed)`` (``prepare_musan.py:49``)."""
    rng = np.random.default_rng(seed)
    files = sorted(glob.glob(os.path.join(speech_root, "**", "*.wav"),
                             recursive=True))
    window = SAMPLERATE * clip_seconds
    os.makedirs(out_root, exist_ok=True)
    splits = ["train"] * (n_mixes * 3 // 4) + ["valid"] * (n_mixes // 8)
    splits += ["test"] * (n_mixes - len(splits))
    for m in range(n_mixes):
        mix = np.zeros(window, np.float32)
        chosen = rng.choice(len(files), size=min(n_speakers, len(files)),
                            replace=False)
        for idx in chosen:
            audio, _ = _read_wav(files[idx])
            clip = audio.mean(axis=1)
            if len(clip) < window:
                clip = np.pad(clip, (0, window - len(clip)))
            start = int(rng.integers(0, max(len(clip) - window, 0) + 1))
            mix += clip[start:start + window]
        mix /= max(np.abs(mix).max(), 1e-9)
        write_audio(os.path.join(out_root, f"{splits[m]}-babble-{m}.wav"),
                    mix * 0.9, SAMPLERATE)


def count_frames(root):
    """The samples of every WAV under ``root`` (``prepare_musan.py:72``)."""
    total = 0
    for file in glob.glob(os.path.join(root, "**", "*.wav"), recursive=True):
        audio, _ = _read_wav(file)
        total += audio.shape[0]
    print(f"{total} frames under {root}")
    return total


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["split", "babble", "count"])
    parser.add_argument("--musan", type=str, default="/path/to/musan")
    parser.add_argument("--out", type=str, default="./noise")
    parser.add_argument("--shard", type=int, default=0)
    parser.add_argument("--nshards", type=int, default=1)
    args = parser.parse_args()
    if args.command == "split":
        split_musan(args.musan, args.out, shard=args.shard,
                    nshards=args.nshards)
    elif args.command == "babble":
        make_musan_babble(os.path.join(args.musan, "speech"), args.out)
    else:
        count_frames(args.out)

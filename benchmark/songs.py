"""Synthetic songs and frame annotations, made from a seed.

The song is ``chip_smoke.py:789 songs_for``: a sine melody that changes
pitch every 4000 samples (a semitone of A3's octave drawn for each step)
plus white noise, drawn here on the device in one batch. The annotations
are ``chip_smoke.py:1602 train_batch``'s: at 49.8 frames a second, onset
and offset flags with probability 0.05, an octave in 0..4 and a pitch class
in 0..12, drawn from a generator keyed by the seed and the song's index, so
that every loader worker draws the same ones.
"""
from __future__ import annotations

import os
import wave

import numpy as np
import torch

SR = 16000
FRAME_RATE = 49.8
STEP = 4000


def derive(*keys):
    """A 63-bit seed from a tuple of whole numbers."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(2)
    return (int(state[0]) << 31 ^ int(state[1])) & (2 ** 63 - 1)


def make_songs(seconds, seed, device):
    """A list of float32 numpy waveforms of the given lengths in seconds."""
    gen = torch.Generator(device).manual_seed(int(seed))
    n = [int(round(s * SR)) for s in seconds]
    longest = max(n)
    steps = -(-longest // STEP)
    semis = torch.randint(0, 12, (len(n), steps), generator=gen, device=device)
    f0 = 220.0 * torch.pow(2.0, semis.double() / 12.0)
    t = torch.arange(longest, device=device, dtype=torch.float64) / SR
    phase = 2 * np.pi * f0.repeat_interleave(STEP, dim=1)[:, :longest] * t
    noise = torch.randn((len(n), longest), generator=gen, device=device,
                        dtype=torch.float32)
    wav = (0.3 * torch.sin(phase)).float() + 0.05 * noise
    wav = wav.cpu().numpy()
    return [np.ascontiguousarray(wav[i, :k]) for i, k in enumerate(n)]


def annotation(seed, index, seconds):
    """(frames, 4) float32 labels of song ``index``."""
    r = np.random.default_rng([int(seed), int(index)])
    frames = int(round(seconds * FRAME_RATE))
    return np.stack([r.random(frames) < 0.05, r.random(frames) < 0.05,
                     r.integers(0, 5, frames), r.integers(0, 13, frames)],
                    axis=-1).astype(np.float32)


def pcm16(wav):
    """``wav`` in [-1, 1] as 16-bit PCM samples."""
    return np.clip(np.round(wav * 32767.0), -32768, 32767).astype("<i2")


def write_wav16(path, wav):
    """``wav`` in [-1, 1] as 16-bit PCM."""
    pcm = pcm16(wav)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def write_song_files(folder, seconds, seed, device, chunk=64):
    """Songs of the given lengths as 16-bit WAV files ``song<i>.wav`` in
    ``folder``, made ``chunk`` at a time; returns {id: {"wav", "duration"}}."""
    os.makedirs(folder, exist_ok=True)
    data = {}
    for lo in range(0, len(seconds), chunk):
        part = seconds[lo:lo + chunk]
        for i, wav in enumerate(make_songs(part, derive(seed, lo), device)):
            idx = lo + i
            path = os.path.join(folder, f"song{idx:05d}.wav")
            write_wav16(path, wav)
            data[f"song{idx:05d}"] = {"wav": path, "duration": part[i],
                                      "index": idx}
    return data


def read_back(seconds, seed, indices, device, chunk=64):
    """{index: float32 waveform} of the songs ``indices`` that
    ``write_song_files`` writes for ``seconds`` and ``seed``, made again
    from the seed as a 16-bit reader gives them back (PCM / 32768)."""
    out = {}
    for lo in sorted({i - i % chunk for i in indices}):
        made = make_songs(seconds[lo:lo + chunk], derive(seed, lo), device)
        for i in indices:
            if lo <= i < lo + chunk:
                out[i] = pcm16(made[i - lo]).astype(np.float32) / np.float32(
                    32768.0)
    return out

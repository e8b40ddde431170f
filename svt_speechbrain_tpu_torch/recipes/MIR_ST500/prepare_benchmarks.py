#!/usr/bin/env python3
"""Data preparation for the AMT benchmark datasets (MIR-ST500, TONAS,
ISMIR2014): port of ``recipes/MIR_ST500/prepare_benchmarks.py``.

Host-side tooling: resampling to 16 kHz mono (polyphase, scipy), per-song
frame labels at 49.8 frames a second (``utils.amt.note2frame``), and CSV
manifests with the song → ``dur_thrd`` utterance split (``utter_id``/
``utter_num`` columns) that the recipes read.

Layout: ``<root>/<song>/vocals.wav`` and a top-level ``Annotations.json``
mapping song id → [[onset, offset, midi], ...].
"""
import argparse
import csv
import json
import os
from math import gcd

import numpy as np

from svt_speechbrain_tpu_torch.dataio.dataio import _read_wav, write_audio
from svt_speechbrain_tpu_torch.utils.amt import note2frame

SAMPLERATE = 16000


def resample_dataset(folder, save_folder):
    """Any rate → 16 kHz mono (``prepare_benchmarks.py:29``)."""
    from scipy.signal import resample_poly

    os.makedirs(save_folder, exist_ok=True)
    for d in sorted(os.listdir(folder)):
        audio_path = os.path.join(folder, d, "vocals.wav")
        if not os.path.exists(audio_path):
            continue
        os.makedirs(os.path.join(save_folder, d), exist_ok=True)
        audio, fs = _read_wav(audio_path)  # (T, C)
        if audio.shape[1] > 1:
            audio = audio.mean(axis=1, keepdims=True)
        if fs != SAMPLERATE:
            g = gcd(SAMPLERATE, fs)
            audio = resample_poly(audio, SAMPLERATE // g, fs // g, axis=0)
        write_audio(os.path.join(save_folder, d, "vocals.wav"), audio[:, 0],
                    SAMPLERATE)


def prepare_frame_anno(gt_file, folder, frame_rate=49.8):
    """Per-song ``annotation.json`` and frame labels ``frame_anno.npy``
    (``prepare_benchmarks.py:50``)."""
    with open(gt_file) as json_data:
        gt = json.load(json_data)
    for d in sorted(os.listdir(folder)):
        if d not in gt:
            continue
        anno = gt[d]
        with open(os.path.join(folder, d, "annotation.json"), "w") as f:
            json.dump(anno, f)
        wav_file = os.path.join(folder, d, "vocals.wav")
        audio, fs = _read_wav(wav_file)
        assert fs == SAMPLERATE, f"{wav_file}: expected {SAMPLERATE} Hz, got {fs}"
        assert audio.shape[1] == 1, f"{wav_file}: expected mono"
        length = round(audio.shape[0] / SAMPLERATE * frame_rate)
        frame_label = note2frame(gt_data=anno, length=length,
                                 frame_size=1 / frame_rate)
        assert frame_label.shape[0] == length
        np.save(os.path.join(folder, d, "frame_anno.npy"), frame_label)


def prepare_csv_benchmarks(folder, save_path, dur_thrd=5):
    """CSV manifest with the song → utterance split
    (``prepare_benchmarks.py:72``): columns
    ``ID,duration,wav,utter_id,utter_num,frame_anno,song_anno``;
    ``utter_num = round(duration / dur_thrd)``, the last utterance up to
    1.5 × dur_thrd."""
    csv_lines = [["ID", "duration", "wav", "utter_id", "utter_num",
                  "frame_anno", "song_anno"]]
    for d in sorted(os.listdir(folder)):
        audio_path = os.path.join(folder, d, "vocals.wav")
        if not os.path.exists(audio_path):
            continue
        anno_path = os.path.join(folder, d, "frame_anno.npy")
        song_anno_path = os.path.join(folder, d, "annotation.json")
        audio, fs = _read_wav(audio_path)
        assert fs == SAMPLERATE
        duration = audio.shape[0] / SAMPLERATE
        utter_num = max(1, round(duration / dur_thrd))
        for i in range(1, utter_num + 1):
            if i == utter_num:
                dur = duration - (utter_num - 1) * dur_thrd
                assert 0 < dur <= dur_thrd * 3 / 2
            else:
                dur = dur_thrd
            csv_lines.append([f"{d}_{i}", str(dur), audio_path, str(i),
                              str(utter_num), anno_path, song_anno_path])
    with open(save_path, "w", newline="") as csv_f:
        csv.writer(csv_f, delimiter=",", quotechar='"',
                   quoting=csv.QUOTE_MINIMAL).writerows(csv_lines)


def prepare_all_AMT_datasets(args, save_folder="./data"):
    """Frame labels and CSVs of the three datasets
    (``prepare_benchmarks.py:105``)."""
    dur_thrd = args.duration
    csv_folder = os.path.join(save_folder, f"dur_{dur_thrd}s")
    os.makedirs(csv_folder, exist_ok=True)
    print(f"save to {csv_folder}")

    mir_train = os.path.join(args.mir_st500, "wav16kHz", "train")
    mir_test = os.path.join(args.mir_st500, "wav16kHz", "test")
    for split_dir in (mir_train, mir_test):
        prepare_frame_anno(os.path.join(args.mir_st500, "Annotations.json"),
                           split_dir, frame_rate=args.frame_rate)
    prepare_frame_anno(os.path.join(args.ismir, "Annotations.json"),
                       os.path.join(args.ismir, "wav16kHz"),
                       frame_rate=args.frame_rate)
    prepare_frame_anno(os.path.join(args.tonas, "Annotations.json"),
                       os.path.join(args.tonas, "wav16kHz"),
                       frame_rate=args.frame_rate)

    prepare_csv_benchmarks(mir_train, os.path.join(
        csv_folder, "mir_st500_train.csv"), dur_thrd)
    prepare_csv_benchmarks(mir_test, os.path.join(
        csv_folder, "mir_st500_test.csv"), dur_thrd)
    prepare_csv_benchmarks(os.path.join(args.ismir, "wav16kHz"),
                           os.path.join(csv_folder, "ismir2014.csv"), dur_thrd)
    prepare_csv_benchmarks(os.path.join(args.tonas, "wav16kHz"),
                           os.path.join(csv_folder, "tonas.csv"), dur_thrd)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--duration", type=int, default=5)
    parser.add_argument("--frame_rate", type=float, default=49.8)
    parser.add_argument("--mir_st500", type=str, default="/path/to/MIR_ST500")
    parser.add_argument("--ismir", type=str, default="/path/to/ISMIR2014")
    parser.add_argument("--tonas", type=str, default="/path/to/TONAS")
    prepare_all_AMT_datasets(parser.parse_args())

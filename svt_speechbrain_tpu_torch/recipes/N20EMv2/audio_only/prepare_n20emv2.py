#!/usr/bin/env python3
"""N20EMv2 audio data preparation (port of
``recipes/N20EMv2/audio_only/prepare_n20emv2.py``).

Layout: ``<root>/annotations.json`` (entry → {"midi": notes, "split":
train/valid/test}) and ``<root>/data/<entry>/vocals.wav``. Writes each
song's ``note_anno.json`` and ``frame_anno.npy`` (49.8 frames a second) and
the split CSVs, then merges ``mir_st500_train.csv`` and ``n20em_train.csv``
into ``mix_train.csv``.

Run:
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only.prepare_n20emv2 \\
>     --n20emv2 /path/to/N20EMv2
"""
import argparse
import csv
import json
import os

import numpy as np

from svt_speechbrain_tpu_torch.dataio.dataio import _read_wav, merge_csvs
from svt_speechbrain_tpu_torch.utils.amt import note2frame

SAMPLERATE = 16000


def prepare_frame_anno(folder, frame_rate=49.8):
    """Each song's note and frame annotations (``prepare_n20emv2.py:26``)."""
    with open(os.path.join(folder, "annotations.json")) as f:
        annotations = json.load(f)
    folder_data = os.path.join(folder, "data")
    for entry in annotations:
        anno = annotations[entry]["midi"]
        with open(os.path.join(folder_data, entry, "note_anno.json"), "w") as f:
            json.dump(anno, f)
        audio, fs = _read_wav(os.path.join(folder_data, entry, "vocals.wav"))
        assert fs == SAMPLERATE and audio.shape[1] == 1
        length = round(audio.shape[0] / SAMPLERATE * frame_rate)
        frame_label = note2frame(gt_data=anno, length=length,
                                 frame_size=1 / frame_rate)
        assert frame_label.shape[0] == length
        np.save(os.path.join(folder_data, entry, "frame_anno.npy"),
                frame_label)


def prepare_csv_n20emv2(folder, csv_folder="./data", dur_thrd=5):
    """``<csv_folder>/dur_<dur_thrd>s/n20em_{train,valid,test}.csv`` with the
    song → utterance split (``prepare_n20emv2.py:44``): ``utter_num =
    round(duration / dur_thrd)``, the last utterance up to 1.5 x
    dur_thrd."""
    header = ["ID", "duration", "wav", "utter_id", "utter_num", "frame_anno",
              "song_anno"]
    lines = {"train": [header], "valid": [header], "test": [header]}
    with open(os.path.join(folder, "annotations.json")) as f:
        annotations = json.load(f)
    folder_data = os.path.join(folder, "data")
    for entry in annotations:
        split = annotations[entry]["split"]
        audio_path = os.path.join(folder_data, entry, "vocals.wav")
        anno_path = os.path.join(folder_data, entry, "frame_anno.npy")
        song_anno_path = os.path.join(folder_data, entry, "note_anno.json")
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
            lines[split].append([f"{entry}_{i}", str(dur), audio_path, str(i),
                                 str(utter_num), anno_path, song_anno_path])
    save_folder = os.path.join(csv_folder, f"dur_{dur_thrd}s")
    os.makedirs(save_folder, exist_ok=True)
    for split, rows in lines.items():
        with open(os.path.join(save_folder, f"n20em_{split}.csv"), "w",
                  newline="") as f:
            csv.writer(f, delimiter=",", quotechar='"',
                       quoting=csv.QUOTE_MINIMAL).writerows(rows)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--duration", type=int, default=5)
    parser.add_argument("--frame_rate", type=float, default=49.8)
    parser.add_argument("--n20emv2", type=str, default="/path/to/N20EMv2")
    args = parser.parse_args()

    prepare_frame_anno(folder=args.n20emv2, frame_rate=args.frame_rate)
    prepare_csv_n20emv2(folder=args.n20emv2, dur_thrd=args.duration)
    merge_csvs(data_folder=os.path.join("./data", f"dur_{args.duration}s"),
               csv_lst=["mir_st500_train.csv", "n20em_train.csv"],
               merged_csv="mix_train.csv")

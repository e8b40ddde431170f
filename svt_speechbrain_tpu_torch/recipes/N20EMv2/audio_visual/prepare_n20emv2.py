#!/usr/bin/env python3
"""N20EMv2 audio-visual preparation (port of
``recipes/N20EMv2/audio_visual/prepare_n20emv2.py``): the feature CSVs of
the fusion stage, whose ``audio`` column is each song's clean wav2vec2
dump (``noise_data/clean_feats.npy``) and ``video`` its visual dump
(``noise_data/video_feats.npy``), split into utterances as the audio
recipe splits songs.

Run:
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.prepare_n20emv2 \\
>     --n20emv2 /path/to/N20EMv2
"""
import argparse
import csv
import json
import os

import numpy as np
import torch


def _feat_len(path):
    """Frames of a ``.npy`` dump, or of its ``.pt`` twin."""
    if os.path.exists(path):
        return np.load(path, mmap_mode="r").shape[0]
    alt = path.replace(".npy", ".pt")
    if os.path.exists(alt):
        return torch.load(alt, map_location="cpu").shape[0]
    raise FileNotFoundError(path)


def prepare_csv_n20emv2_feat(folder, csv_folder="./data", dur_thrd=5,
                             frame_rate=49.8):
    """``<csv_folder>/dur_<dur_thrd>s/n20em_{train,valid,test}.csv``
    (``prepare_n20emv2.py:25``): a song of F audio frames lasts F /
    ``frame_rate`` seconds."""
    header = ["ID", "duration", "audio", "video", "utter_id", "utter_num",
              "frame_anno", "song_anno"]
    lines = {"train": [header], "valid": [header], "test": [header]}
    with open(os.path.join(folder, "annotations.json")) as f:
        annotations = json.load(f)
    folder_data = os.path.join(folder, "data")
    for entry in annotations:
        split = annotations[entry]["split"]
        audio_path = os.path.join(folder_data, entry, "noise_data",
                                  "clean_feats.npy")
        video_path = os.path.join(folder_data, entry, "noise_data",
                                  "video_feats.npy")
        anno_path = os.path.join(folder_data, entry, "frame_anno.npy")
        song_anno_path = os.path.join(folder_data, entry, "note_anno.json")
        duration = _feat_len(audio_path) / frame_rate
        utter_num = max(1, round(duration / dur_thrd))
        for i in range(1, utter_num + 1):
            if i == utter_num:
                dur = duration - (utter_num - 1) * dur_thrd
            else:
                dur = dur_thrd
            lines[split].append([f"{entry}_{i}", str(dur), audio_path,
                                 video_path, str(i), str(utter_num),
                                 anno_path, song_anno_path])
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
    prepare_csv_n20emv2_feat(folder=args.n20emv2, dur_thrd=args.duration,
                             frame_rate=args.frame_rate)

#!/usr/bin/env python3
"""N20EMv2 video data preparation (port of
``recipes/N20EMv2/video_only/prepare_n20emv2.py``).

Layout: ``<root>/annotations.json`` (entry → {"midi": notes, "split":
train/valid/test}) and ``<root>/data/<entry>/video_<rate>fps.npy``, the
(T, H, W) uint8 lip ROIs. Writes each song's ``note_anno.json`` and
``video_anno/<rate>fps/video_frame_anno.npy`` (one row per video frame) and
the split CSVs ``<csv_folder>/frame_rate<rate>/dur_<d>s/n20em_{train,valid,
test}.csv`` with columns ``ID,duration,video,utter_id,utter_num,frame_anno,
song_anno``.

Run:
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only.prepare_n20emv2 \\
>     --n20emv2 /path/to/N20EMv2
"""
import argparse
import csv
import json
import os

import numpy as np

from svt_speechbrain_tpu_torch.utils.amt import note2frame


def prepare_frame_anno(folder, frame_rate=50):
    """Each song's note and per-video-frame annotations
    (``prepare_n20emv2.py:22``)."""
    with open(os.path.join(folder, "annotations.json")) as f:
        annotations = json.load(f)
    folder_data = os.path.join(folder, "data")
    for entry in annotations:
        anno = annotations[entry]["midi"]
        with open(os.path.join(folder_data, entry, "note_anno.json"), "w") as f:
            json.dump(anno, f)
        video = np.load(os.path.join(folder_data, entry,
                                     f"video_{frame_rate}fps.npy"),
                        mmap_mode="r")
        frame_label = note2frame(gt_data=anno, length=video.shape[0],
                                 frame_size=1 / frame_rate)
        anno_dir = os.path.join(folder_data, entry, "video_anno",
                                f"{frame_rate}fps")
        os.makedirs(anno_dir, exist_ok=True)
        np.save(os.path.join(anno_dir, "video_frame_anno.npy"), frame_label)


def prepare_csv_n20emv2(folder, csv_folder="./data", frame_rate=50,
                        dur_thrd=5):
    """The split CSVs (``prepare_n20emv2.py:40``): ``utter_num =
    round(duration / dur_thrd)``, the last utterance up to 1.5 x
    dur_thrd."""
    header = ["ID", "duration", "video", "utter_id", "utter_num",
              "frame_anno", "song_anno"]
    lines = {"train": [header], "valid": [header], "test": [header]}
    with open(os.path.join(folder, "annotations.json")) as f:
        annotations = json.load(f)
    folder_data = os.path.join(folder, "data")
    for entry in annotations:
        split = annotations[entry]["split"]
        video_path = os.path.join(folder_data, entry,
                                  f"video_{frame_rate}fps.npy")
        anno_path = os.path.join(folder_data, entry, "video_anno",
                                 f"{frame_rate}fps", "video_frame_anno.npy")
        song_anno_path = os.path.join(folder_data, entry, "note_anno.json")
        video = np.load(video_path, mmap_mode="r")
        duration = video.shape[0] / frame_rate
        utter_num = max(1, round(duration / dur_thrd))
        for i in range(1, utter_num + 1):
            if i == utter_num:
                dur = duration - (utter_num - 1) * dur_thrd
                assert 0 < dur <= dur_thrd * 3 / 2
            else:
                dur = dur_thrd
            lines[split].append([f"{entry}_{i}", str(dur), video_path, str(i),
                                 str(utter_num), anno_path, song_anno_path])
    save_folder = os.path.join(csv_folder, f"frame_rate{frame_rate}",
                               f"dur_{dur_thrd}s")
    os.makedirs(save_folder, exist_ok=True)
    for split, rows in lines.items():
        with open(os.path.join(save_folder, f"n20em_{split}.csv"), "w",
                  newline="") as f:
            csv.writer(f, delimiter=",", quotechar='"',
                       quoting=csv.QUOTE_MINIMAL).writerows(rows)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--duration", type=int, default=5)
    parser.add_argument("--frame_rate", type=int, default=50)
    parser.add_argument("--n20emv2", type=str, default="/path/to/N20EMv2")
    args = parser.parse_args()
    prepare_frame_anno(folder=args.n20emv2, frame_rate=args.frame_rate)
    prepare_csv_n20emv2(folder=args.n20emv2, frame_rate=args.frame_rate,
                        dur_thrd=args.duration)

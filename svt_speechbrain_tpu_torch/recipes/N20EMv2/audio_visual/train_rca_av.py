#!/usr/bin/env python3
"""Recipe: stage-2 RCA audio-visual fusion AMT over pre-extracted features
(port of ``recipes/N20EMv2/audio_visual/train_rca_av.py``; the same command
line, data preparation and hyperparameters).

Residual cross-attention fusion of the stage-1 wav2vec2 features (49.8
frames a second) and visual features (50 a second), one Adadelta over the
fusion network and the frame head, the head warm-started from stage 1's
export, each song's notes dumped; ``add_noise``/``noise_type``/``snr_db``
read the noisy feature dumps in place of the clean ones.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.train_rca_av \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/audio_visual/hparams/train_rca_av.yaml \\
>     --data_folder=/path/to/N20EMv2
"""
import json
import logging
import os

import numpy as np
import torch

from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.core import (create_experiment_directory,
                                            parse_arguments)
from svt_speechbrain_tpu_torch.dataio import dataset
from svt_speechbrain_tpu_torch.parallel.distributed import ddp_init_group
from svt_speechbrain_tpu_torch.tasks.amt import FusionAMT

logger = logging.getLogger(__name__)


class AMT(FusionAMT):
    """The AV fusion AMT (``train_rca_av.py:28``)."""


def _load_feats(path):
    """A feature dump: ``.npy`` (both packages write it) or ``.pt``."""
    if path.endswith(".npy"):
        return np.load(path)
    return torch.load(path, map_location="cpu").numpy()


def dataio_prepare(hparams):
    """Datasets and their pipelines (``train_rca_av.py:41``): each
    utterance is a ``dur_threshold`` slice of its song's audio features
    (at ``audio_sample_rate`` frames a second; the noisy dump under
    ``add_noise``) and of its video features (at ``video_sample_rate``),
    the video cut or zero-padded to the audio's frame count, with the frame
    annotations and the song's note references."""
    data_folder = hparams["data_folder"]
    train_data = dataset.DynamicItemDataset.from_csv(
        csv_path=hparams["train_csv"], replacements={"data_root": data_folder})
    if hparams["sorting"] in ("ascending", "descending"):
        train_data = train_data.filtered_sorted(
            sort_key="duration", reverse=hparams["sorting"] == "descending")
        hparams["train_dataloader_opts"]["shuffle"] = False
    elif hparams["sorting"] != "random":
        raise NotImplementedError(
            "sorting must be random, ascending or descending")
    valid_data = dataset.DynamicItemDataset.from_csv(
        csv_path=hparams["valid_csv"], replacements={"data_root": data_folder})
    test_datasets = {}
    for csv_file in hparams["test_csv"]:
        name = os.path.splitext(os.path.basename(csv_file))[0]
        test_datasets[name] = dataset.DynamicItemDataset.from_csv(
            csv_path=csv_file, replacements={"data_root": data_folder})
    datasets = [train_data, valid_data] + list(test_datasets.values())

    dur_threshold = hparams["dur_threshold"]
    rate1 = hparams["audio_sample_rate"]
    rate2 = hparams["video_sample_rate"]
    frame_rate = hparams["frame_rate"]

    def audio_visual_pipeline(audio, video, utter_id, utter_num):
        if hparams.get("add_noise"):
            stem = f"SNR_{hparams['snr_db']}dB_feats"
            for ext in (".npy", ".pt"):
                cand = os.path.join(os.path.dirname(audio),
                                    hparams["noise_type"], stem + ext)
                if os.path.exists(cand):
                    audio = cand
                    break
        sig1 = _load_feats(audio)
        sig2 = _load_feats(video)
        utter_id, utter_num = int(utter_id), int(utter_num)
        start1 = round((utter_id - 1) * rate1 * dur_threshold)
        start2 = round((utter_id - 1) * rate2 * dur_threshold)
        if utter_id == utter_num:
            sig1, sig2 = sig1[start1:], sig2[start2:]
        else:
            sig1 = sig1[start1:round(utter_id * rate1 * dur_threshold)]
            sig2 = sig2[start2:round(utter_id * rate2 * dur_threshold)]
        frame1, frame2 = sig1.shape[0], sig2.shape[0]
        if frame1 < frame2:
            sig2 = sig2[:frame1]
        elif frame1 > frame2:
            sig2 = np.concatenate(
                [sig2, np.zeros((frame1 - frame2, sig2.shape[1]), sig2.dtype)])
        return sig1.astype(np.float32), sig2.astype(np.float32)

    dataset.add_dynamic_item(datasets, audio_visual_pipeline,
                             takes=["audio", "video", "utter_id", "utter_num"],
                             provides=["sig1", "sig2"])

    def anno_items(frame_anno, song_anno, utter_id, utter_num):
        utter_id, utter_num = int(utter_id), int(utter_num)
        with open(song_anno) as f:
            song_np = np.array(json.load(f), dtype=np.float64)
        anno = np.load(frame_anno)
        start = round((utter_id - 1) * frame_rate * dur_threshold)
        if utter_id == utter_num:
            anno = anno[start:]
        else:
            anno = anno[start:round(utter_id * frame_rate * dur_threshold)]
        return anno, utter_id, utter_num, song_np[:, :2], song_np[:, 2]

    dataset.add_dynamic_item(
        datasets, anno_items,
        takes=["frame_anno", "song_anno", "utter_id", "utter_num"],
        provides=["anno", "cur_utter", "all_utter", "ref_intervals",
                  "ref_pitchs"])
    dataset.set_output_keys(
        datasets, ["id", "sig1", "sig2", "anno", "cur_utter", "all_utter",
                   "ref_intervals", "ref_pitchs", "audio"])
    return train_data, valid_data, test_datasets


def load_hparams(argv=None):
    """The command line on ``argv`` (the process's arguments when None):
    the yaml with its overrides, the experiment folder, and the modules'
    seeded random weights (``seed``). Returns (hparams, run_opts)."""
    hparams_file, run_opts, overrides = parse_arguments(argv)
    ddp_init_group(run_opts)
    with open(hparams_file) as fin:
        hparams = load_hyperyaml(fin, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file, overrides=overrides)
    init_modules(hparams["modules"], hparams["seed"])
    return hparams, run_opts


def main(brain_cls=AMT, argv=None):
    """Fit, then evaluate every test set from the checkpoint of greatest
    valid COnPOff F1 (``train_rca_av.py:126``). Returns the brain."""
    hparams, run_opts = load_hparams(argv)
    train_data, valid_data, test_datasets = dataio_prepare(hparams)
    amt_brain = brain_cls(modules=hparams["modules"], hparams=hparams,
                          run_opts=run_opts,
                          checkpointer=hparams["checkpointer"])
    amt_brain.fit(amt_brain.hparams.epoch_counter, train_data, valid_data,
                  train_loader_kwargs=hparams["train_dataloader_opts"],
                  valid_loader_kwargs=hparams["valid_dataloader_opts"])
    for test_set in test_datasets.values():
        amt_brain.evaluate(test_set, max_key="COnPOff_f1",
                           test_loader_kwargs=hparams["test_dataloader_opts"])
    return amt_brain


if __name__ == "__main__":
    main()

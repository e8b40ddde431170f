#!/usr/bin/env python3
"""Recipe: wav2vec2 audio AMT on N20EMv2, optionally mixed with MIR-ST500
(port of ``recipes/N20EMv2/audio_only/train_audio_ssl.py``; the same
command line, data preparation and hyperparameters).

Its departures from the MIR-ST500 recipe: the offset BCE's
``offset_positive_weight``, COff scoring, the ``mix_train`` switch (train
on ``mix_train.csv``), the ``add_noise`` switch (read
``noise_data/<noise_type>/SNR_<snr_db>dB.wav`` in place of each song's
clean WAV), the checkpoint of greatest valid COnPOff F1 kept, and the
``save_model`` export of ``wav2vec2.pt``/``model.pt`` at each ``evaluate``
for the fusion stage.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only.train_audio_ssl \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/audio_only/hparams/train_audio_ssl.yaml \\
>     --data_folder=/path/to/N20EMv2
"""
import json
import logging
import os

import numpy as np

from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.core import (create_experiment_directory,
                                            parse_arguments)
from svt_speechbrain_tpu_torch.dataio import dataio, dataset
from svt_speechbrain_tpu_torch.parallel.distributed import ddp_init_group
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT

logger = logging.getLogger(__name__)


class AMT(AudioAMT):
    """N20EMv2 audio AMT: ``AudioAMT`` with the yaml's ``compute_coff`` and
    ``ckpt_policy: max_COnPOff_f1``."""


def dataio_prepare(hparams, extract=False):
    """Datasets and their pipelines (``train_audio_ssl.py:30``): the train
    set from ``mix_train_csv`` when ``mix_train`` is set, sorted by
    duration (stable) unless ``sorting`` is random; valid and test sets in
    song order. Each utterance is a ``dur_threshold`` slice of its song's
    WAV (the noisy one under ``add_noise``) and of its frame annotations,
    with the song's note references; ``extract`` keeps the WAV path in the
    outputs for the feature dumps."""
    data_folder = hparams["data_folder"]
    train_csv = (hparams["mix_train_csv"] if hparams.get("mix_train")
                 else hparams["train_csv"])
    train_data = dataset.DynamicItemDataset.from_csv(
        csv_path=train_csv, replacements={"data_root": data_folder})

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
    sample_rate = hparams["sample_rate"]
    frame_rate = hparams["frame_rate"]

    def audio_pipeline(wav, utter_id, utter_num):
        if hparams.get("add_noise"):
            wav = os.path.join(os.path.dirname(wav), "noise_data",
                               hparams["noise_type"],
                               f"SNR_{hparams['snr_db']}dB.wav")
        sig = dataio.read_audio(wav)
        assert sig.ndim == 1
        utter_id, utter_num = int(utter_id), int(utter_num)
        start = round((utter_id - 1) * sample_rate * dur_threshold)
        if utter_id == utter_num:
            return sig[start:]
        return sig[start:round(utter_id * sample_rate * dur_threshold)]

    dataset.add_dynamic_item(datasets, audio_pipeline,
                             takes=["wav", "utter_id", "utter_num"],
                             provides="sig")

    def anno_items(frame_anno, song_anno, utter_id, utter_num):
        utter_id, utter_num = int(utter_id), int(utter_num)
        with open(song_anno) as json_data:
            song_np = np.array(json.load(json_data), dtype=np.float64)
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
    keys = ["id", "sig", "anno", "cur_utter", "all_utter", "ref_intervals",
            "ref_pitchs"]
    dataset.set_output_keys(datasets, keys + ["wav"] if extract else keys)
    return train_data, valid_data, test_datasets


def load_hparams(argv=None):
    """The command line (``train_audio_ssl.py:105-114``) on ``argv`` (the
    process's arguments when None): the yaml with its overrides, the
    experiment folder, and the modules' seeded random weights (``seed``;
    a HF checkpoint at ``wav2vec2_local`` replaces them at fit start).
    Returns (hparams, run_opts)."""
    hparams_file, run_opts, overrides = parse_arguments(argv)
    ddp_init_group(run_opts)
    with open(hparams_file) as fin:
        hparams = load_hyperyaml(fin, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file, overrides=overrides)
    init_modules(hparams["modules"], hparams["seed"])
    return hparams, run_opts


def main(argv=None):
    """Fit, then evaluate every test set from the checkpoint of greatest
    valid COnPOff F1. Returns the brain."""
    hparams, run_opts = load_hparams(argv)
    train_data, valid_data, test_datasets = dataio_prepare(hparams)
    amt_brain = AMT(modules=hparams["modules"], hparams=hparams,
                    run_opts=run_opts, checkpointer=hparams["checkpointer"])
    amt_brain.fit(amt_brain.hparams.epoch_counter, train_data, valid_data,
                  train_loader_kwargs=hparams["train_dataloader_opts"],
                  valid_loader_kwargs=hparams["valid_dataloader_opts"])
    for test_set in test_datasets.values():
        amt_brain.evaluate(test_set, max_key="COnPOff_f1",
                           test_loader_kwargs=hparams["test_dataloader_opts"])
    return amt_brain


if __name__ == "__main__":
    main()

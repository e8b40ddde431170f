#!/usr/bin/env python3
"""Recipe: wav2vec2-based AMT on MIR-ST500 (port of
``recipes/MIR_ST500/train_audio_ssl.py``; the same command line, data
preparation and hyperparameters).

wav2vec2-large-lv60 plus a 20-logit linear head; the 4-term frame loss;
Adam on the encoder and Adadelta on the head; linear probing, then full
finetuning; NewBob annealing on the valid loss; the best checkpoint by valid
loss kept; song-stitched evaluation of every test set from it, scored with
COnPOff/COnP/COn.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.MIR_ST500.train_audio_ssl \\
>     svt_speechbrain_tpu_torch/recipes/MIR_ST500/hparams/train_audio_ssl.yaml \\
>     --data_folder=/path/to/MIR_ST500
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
    """MIR-ST500 audio AMT: ``AudioAMT`` with the recipe's checkpoint policy,
    the best checkpoint by min valid loss (``train_audio_ssl.py:41``)."""


def dataio_prepare(hparams):
    """Datasets and their pipelines (``train_audio_ssl.py:50-118``): the
    train set sorted by duration (stable), the valid and test sets in song
    order; each utterance is a ``dur_threshold`` slice of its song's WAV and
    of its frame annotations, with the song's note references."""
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
    # never filter or sort an eval set: a song's utterances stay together
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
    dataset.set_output_keys(
        datasets, ["id", "sig", "anno", "cur_utter", "all_utter",
                   "ref_intervals", "ref_pitchs"])
    return train_data, valid_data, test_datasets


def main(argv=None):
    """The command line (``train_audio_ssl.py:121-159``) on ``argv`` (the
    process's arguments when None): fit, then evaluate every test set from
    the checkpoint of least valid loss. The modules start from seeded random
    weights (``seed``), or from a HF checkpoint at ``wav2vec2_local``.
    Returns the brain."""
    hparams_file, run_opts, overrides = parse_arguments(argv)
    ddp_init_group(run_opts)
    with open(hparams_file) as fin:
        hparams = load_hyperyaml(fin, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file, overrides=overrides)
    init_modules(hparams["modules"], hparams["seed"])
    train_data, valid_data, test_datasets = dataio_prepare(hparams)
    amt_brain = AMT(modules=hparams["modules"], hparams=hparams,
                    run_opts=run_opts, checkpointer=hparams["checkpointer"])
    amt_brain.fit(amt_brain.hparams.epoch_counter, train_data, valid_data,
                  train_loader_kwargs=hparams["train_dataloader_opts"],
                  valid_loader_kwargs=hparams["valid_dataloader_opts"])
    for test_set in test_datasets.values():
        amt_brain.evaluate(test_set, min_key="loss",
                           test_loader_kwargs=hparams["test_dataloader_opts"])
    return amt_brain


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Recipe: AV-HuBERT visual-encoder AMT over 50 fps lip-ROI video (port of
``recipes/N20EMv2/video_only/train_video_ssl.py``; the same command line,
data preparation and hyperparameters).

AV-HuBERT's visual path (video only, the audio stream zero-filled) and a
linear frame head. Train-time transforms: Normalize(0, 255) → RandomCrop
88 → HorizontalFlip(0.5) → Normalize(0.421, 0.165); eval: CenterCrop 88.
``split_noise`` jitters the train utterances' boundaries. COff is scored
and the checkpoint of greatest valid COnPOff F1 kept. One numpy generator
(``seed``) draws, for each train utterance in the loader's order, the
jitter, then the crop, then the flip, as the JAX recipe's does; the video
is sliced to the utterance before the (elementwise and spatial)
transforms, which gives the values of transforming the whole song first.
The generator's state is checkpointed (``transform_rng``), so a recovered
run draws the crops an uninterrupted one would; the JAX recipe starts it
afresh.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only.train_video_ssl \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/video_only/hparams/train_video_ssl.yaml \\
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
from svt_speechbrain_tpu_torch.dataio import dataset
from svt_speechbrain_tpu_torch.parallel.distributed import ddp_init_group
from svt_speechbrain_tpu_torch.processing.video import (CenterCrop, Compose,
                                                        HorizontalFlip,
                                                        Normalize, RandomCrop)
from svt_speechbrain_tpu_torch.tasks.amt import VideoAMT
from svt_speechbrain_tpu_torch.utils.checkpoints import PytreeHandle

logger = logging.getLogger(__name__)

IMAGE_CROP_SIZE = 88
IMAGE_MEAN = 0.421
IMAGE_STD = 0.165


class AMT(VideoAMT):
    """N20EMv2 video AMT: ``VideoAMT`` with the yaml's ``compute_coff`` and
    ``ckpt_policy: max_COnPOff_f1``."""


def dataio_prepare(hparams, extract=False):
    """Datasets and their pipelines (``train_video_ssl.py:35``): the train
    set sorted by duration (stable) unless ``sorting`` is random, valid and
    test sets in song order. A train utterance is a ``dur_threshold`` slice
    of its song's video and frame annotations, its boundaries jittered by
    up to half a stride under ``split_noise``; an eval utterance is the
    plain slice, with the song's note references. ``extract`` keeps the
    video path in the eval outputs for the feature dumps. The transforms'
    generator is registered with the checkpointer."""
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
    eval_datasets = [valid_data] + list(test_datasets.values())

    dur_threshold = hparams["dur_threshold"]
    sample_rate = hparams["sample_rate"]       # video frames a second
    frame_rate = hparams["frame_rate"]
    split_noise = hparams["split_noise"]
    stride = dur_threshold - hparams.get("overlap", 0)

    rng = np.random.default_rng(hparams["seed"])
    if hparams.get("checkpointer") is not None:
        hparams["checkpointer"].add_recoverable("transform_rng", PytreeHandle(
            get=lambda: rng.bit_generator.state,
            set=lambda state: setattr(rng.bit_generator, "state", state)))
    crop = (IMAGE_CROP_SIZE, IMAGE_CROP_SIZE)
    transform_train = Compose([Normalize(0.0, 255.0),
                               RandomCrop(crop, rng=rng),
                               HorizontalFlip(0.5, rng=rng),
                               Normalize(IMAGE_MEAN, IMAGE_STD)])
    transform_eval = Compose([Normalize(0.0, 255.0), CenterCrop(crop),
                              Normalize(IMAGE_MEAN, IMAGE_STD)])

    def _slice(arr, rate, utter_id, utter_num, duration, shift):
        """Boundary slice with jitter ``shift`` (``train_video_ssl.py:77``)."""
        if utter_id == 1:
            n1 = round(rate * abs(shift))
            return arr[n1:n1 + round(rate * dur_threshold)]
        if utter_id == utter_num:
            if duration < dur_threshold:
                n = round((utter_id - 1) * rate * stride - rate * abs(shift))
            else:
                n = round((utter_id - 1) * rate * stride + rate * abs(shift))
            return arr[n:]
        n1 = round((utter_id - 1) * rate * stride + rate * shift)
        n2 = round((utter_id - 1) * rate * stride + rate * shift
                   + rate * dur_threshold)
        return arr[n1:n2]

    def _frames(video, transform):
        return np.expand_dims(transform(video), axis=-1).astype(np.float32)

    def utterance_train_pipeline(video, duration, frame_anno, utter_id,
                                 utter_num):
        shift = (float(rng.random()) * stride - stride / 2 if split_noise
                 else 0.0)
        utter_id, utter_num = int(utter_id), int(utter_num)
        duration = float(duration)
        sig = _slice(np.load(video, mmap_mode="r"), sample_rate, utter_id,
                     utter_num, duration, shift)
        sig = _frames(np.asarray(sig), transform_train)
        anno = _slice(np.load(frame_anno), frame_rate, utter_id, utter_num,
                      duration, shift)
        return sig, anno, utter_id, utter_num

    def _eval_slice(arr, rate, utter_id, utter_num):
        start = round((utter_id - 1) * rate * dur_threshold)
        if utter_id == utter_num:
            return arr[start:]
        return arr[start:round(utter_id * rate * dur_threshold)]

    def utterance_eval_pipeline(video, frame_anno, song_anno, utter_id,
                                utter_num):
        utter_id, utter_num = int(utter_id), int(utter_num)
        sig = _eval_slice(np.load(video, mmap_mode="r"), sample_rate,
                          utter_id, utter_num)
        sig = _frames(np.asarray(sig), transform_eval)
        anno = _eval_slice(np.load(frame_anno), frame_rate, utter_id,
                           utter_num)
        with open(song_anno) as f:
            song_np = np.array(json.load(f), dtype=np.float64)
        return sig, anno, utter_id, utter_num, song_np[:, :2], song_np[:, 2]

    dataset.add_dynamic_item(
        [train_data], utterance_train_pipeline,
        takes=["video", "duration", "frame_anno", "utter_id", "utter_num"],
        provides=["sig", "anno", "cur_utter", "all_utter"])
    dataset.add_dynamic_item(
        eval_datasets, utterance_eval_pipeline,
        takes=["video", "frame_anno", "song_anno", "utter_id", "utter_num"],
        provides=["sig", "anno", "cur_utter", "all_utter", "ref_intervals",
                  "ref_pitchs"])
    dataset.set_output_keys([train_data],
                            ["id", "sig", "anno", "cur_utter", "all_utter"])
    eval_keys = ["id", "sig", "anno", "cur_utter", "all_utter",
                 "ref_intervals", "ref_pitchs"]
    dataset.set_output_keys(eval_datasets,
                            eval_keys + ["video"] if extract else eval_keys)
    return train_data, valid_data, test_datasets


def load_hparams(argv=None):
    """The command line on ``argv`` (the process's arguments when None):
    the yaml with its overrides, the experiment folder, and the modules'
    seeded random weights (``seed``; a fairseq checkpoint at the encoder's
    ``source`` replaces them at fit start). Returns (hparams, run_opts)."""
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

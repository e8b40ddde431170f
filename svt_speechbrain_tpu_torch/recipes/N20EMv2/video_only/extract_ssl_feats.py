#!/usr/bin/env python3
"""Recipe: dump per-song AV-HuBERT visual features for the fusion stage
(port of ``recipes/N20EMv2/video_only/extract_ssl_feats.py``).

The trained video AMT model, recovered from the checkpoint of greatest
valid COnPOff F1, evaluates the valid set and every set of ``test_csv``
(the extract yaml lists test, valid and train) in song order with
``return_feats``; each song's encoder features, concatenated over its
utterances (one row per video frame), go to
``<song>/noise_data/video_feats.npy``, which the fusion recipes read.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only.extract_ssl_feats \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/video_only/hparams/extract_ssl_feats.yaml \\
>     --data_folder=/path/to/N20EMv2
"""
import logging

from svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only.train_video_ssl import (
    AMT, dataio_prepare, load_hparams)

logger = logging.getLogger(__name__)


def extract(hparams, run_opts, brain_cls=AMT):
    """Evaluate the valid set, then each test set, in song order with
    feature dumps on (``extract_ssl_feats.py:32-36``). Returns the
    brain."""
    _, valid_data, test_datasets = dataio_prepare(hparams, extract=True)
    amt_brain = brain_cls(modules=hparams["modules"], hparams=hparams,
                          run_opts=run_opts,
                          checkpointer=hparams["checkpointer"])
    amt_brain.return_feats = True
    for name, data in [("valid", valid_data), *test_datasets.items()]:
        logger.info(f"Extracting visual features for split: {name}")
        amt_brain.evaluate(data, max_key="COnPOff_f1",
                           test_loader_kwargs=hparams["test_dataloader_opts"])
    return amt_brain


def main(argv=None):
    hparams, run_opts = load_hparams(argv)
    return extract(hparams, run_opts)


if __name__ == "__main__":
    main()

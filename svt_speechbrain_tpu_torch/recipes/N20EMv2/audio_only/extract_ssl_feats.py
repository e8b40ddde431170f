#!/usr/bin/env python3
"""Recipe: dump per-song wav2vec2 features for the fusion stage (port of
``recipes/N20EMv2/audio_only/extract_ssl_feats.py``).

The trained audio AMT model, recovered from the checkpoint of greatest
valid COnPOff F1, evaluates every split in song order with
``return_feats``; each song's encoder features, concatenated over its
utterances, go to ``<song>/noise_data/clean_feats.npy`` or, under
``add_noise``, ``<song>/noise_data/<noise_type>/SNR_<snr_db>dB_feats.npy``
(``.npy``, which both packages read). ``save_model`` exports the encoder
and head at each ``evaluate``.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only.extract_ssl_feats \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/audio_only/hparams/extract_ssl_feats.yaml \\
>     --data_folder=/path/to/N20EMv2 [--add_noise=True --noise_type=accomp --snr_db=0]
"""
import logging

from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only.train_audio_ssl import (
    AMT, dataio_prepare, load_hparams)

logger = logging.getLogger(__name__)


def extract(hparams, run_opts, brain_cls=AMT):
    """Evaluate train, valid and every test set in song order with feature
    dumps on (``extract_ssl_feats.py:32-42``). Returns the brain."""
    train_data, valid_data, test_datasets = dataio_prepare(hparams,
                                                           extract=True)
    amt_brain = brain_cls(modules=hparams["modules"], hparams=hparams,
                          run_opts=run_opts,
                          checkpointer=hparams["checkpointer"])
    amt_brain.return_feats = True
    for name, data in [("train", train_data), ("valid", valid_data),
                       *test_datasets.items()]:
        logger.info(f"Extracting features for split: {name}")
        amt_brain.evaluate(data, max_key="COnPOff_f1",
                           test_loader_kwargs=hparams["test_dataloader_opts"])
    return amt_brain


def main(argv=None):
    hparams, run_opts = load_hparams(argv)
    return extract(hparams, run_opts)


if __name__ == "__main__":
    main()

"""Audio AMT (singing-voice note transcription) training brain (port of the
training side of ``svt_speechbrain_tpu/tasks/amt.py:62-290``).

``AudioAMT`` trains wav2vec2 plus a linear frame head with the recipe's
4-term frame loss (``:106-125``) and two optimizers: Adam on ``wav2vec2``
at ``lr_wav2vec`` and Adadelta (rho 0.95, eps 1e-8) on ``model`` at ``lr``.
The first ``linear_prob_epochs`` epochs freeze ``wav2vec2`` (linear
probing); later epochs fine-tune everything. In both, wav2vec2 runs in
train mode (dropout on), as the JAX brain does.

Evaluation (song stitching, note decoding and COnPOff scoring through
``utils/transcription_eval``) waits for a later slice.
"""
from __future__ import annotations

import functools
import logging

import torch

from svt_speechbrain_tpu_torch.core import Brain, Stage

logger = logging.getLogger(__name__)


class AudioAMT(Brain):
    """wav2vec2 + linear head audio AMT (``tasks/amt.py:250``).

    ``hparams`` holds, as the recipe's yaml: ``pitch_octave_num``,
    ``onset_positive_weight`` (and optionally ``offset_positive_weight``),
    ``onset_criterion``/``offset_criterion`` (``bce_loss`` partials),
    ``octave_criterion``/``pitch_criterion`` (``nll_loss`` partials),
    ``log_softmax`` (``Softmax(apply_log=True)``), ``lr``, ``lr_wav2vec``
    and ``linear_prob_epochs``. ``modules`` are ``wav2vec2``
    (``HuggingFaceWav2Vec2``) and ``model`` (``Linear``).
    """

    def compute_forward(self, batch, stage, rng=None):
        if stage != Stage.TRAIN:
            raise NotImplementedError("evaluation is not ported yet")
        wavs, wav_lens = batch["sig"]
        # train matches the reference: padding attended, batch-wide norms
        feats = self.modules.wav2vec2(wavs, rng=rng, train=True,
                                      row_mask=batch.get("valid_rows"))
        logits = self.modules.model(feats)
        n_oct = self.hparams.pitch_octave_num
        return (logits[:, :, 0], logits[:, :, 1],
                logits[:, :, 2:3 + n_oct], logits[:, :, 3 + n_oct:], wav_lens)

    def compute_objectives(self, predictions, batch, stage):
        """4-term masked loss (``tasks/amt.py:106-125``)."""
        onset_logits, offset_logits, octave_logits, class_logits = predictions[:4]
        anno, anno_lens = batch["anno"]
        hp = self.hparams
        onset_loss = hp.onset_criterion(
            onset_logits, anno[:, :, 0].float(), length=anno_lens,
            pos_weight=hp.onset_positive_weight)
        offset_loss = hp.offset_criterion(
            offset_logits, anno[:, :, 1].float(), length=anno_lens,
            pos_weight=getattr(hp, "offset_positive_weight", 1.0))
        octave_loss = hp.octave_criterion(
            hp.log_softmax(octave_logits), anno[:, :, 2].long(),
            length=anno_lens)
        pitch_loss = hp.pitch_criterion(
            hp.log_softmax(class_logits), anno[:, :, 3].long(),
            length=anno_lens)
        return onset_loss + offset_loss + octave_loss + pitch_loss

    def on_stage_start(self, stage, epoch=None):
        if stage != Stage.TRAIN:
            raise NotImplementedError("evaluation is not ported yet")
        self.configure_freezing(epoch)

    def configure_freezing(self, epoch):
        if epoch is not None and epoch <= getattr(self.hparams,
                                                  "linear_prob_epochs", 0):
            logger.info("Stage for linear probing")
            self.set_frozen_modules(["wav2vec2"])
        else:
            logger.info("Stage for full finetuning")
            self.set_frozen_modules([])

    def init_optimizers(self):
        self.add_optimizer("wav2vec", torch.optim.Adam, ["wav2vec2"],
                           lr=self.hparams.lr_wav2vec)
        self.add_optimizer(
            "model", functools.partial(torch.optim.Adadelta, rho=0.95,
                                       eps=1e-8),
            ["model"], lr=self.hparams.lr)

"""AMT (singing-voice note transcription) brains (port of
``svt_speechbrain_tpu/tasks/amt.py``).

``AMTBrainBase`` holds what the AMT recipes share: the 4-term frame loss,
song-stitched evaluation (batch 1, utterances of a song in order) decoded
by ``frame2note`` and scored with COnPOff/COnP/COn (and COff) through
``utils.transcription_eval``, NewBob annealing of both optimizers on the
valid loss, and the checkpoint policies ``min_loss`` and ``max_COnPOff_f1``.
``AudioAMT`` trains wav2vec2 plus a linear frame head: Adam on ``wav2vec2``
at ``lr_wav2vec`` and Adadelta (rho 0.95, eps 1e-8) on ``model`` at ``lr``;
the first ``linear_prob_epochs`` epochs freeze ``wav2vec2`` (linear
probing). Training runs wav2vec2 in train mode (dropout on, batch-wide
norms, padding attended); evaluation runs it on the exact lengths
(``wav_lens``: per-row norms over the real samples, padded frames masked).
``VideoAMT`` trains AV-HuBERT's visual path (``FairseqAVHubert`` over lip
ROIs) plus the frame head, with the BatchNorm running statistics in the
encoder's buffers. ``FusionAMT`` trains the RCA fusion network plus the
frame head over pre-extracted audio and video features (stage 2 of
N20EMv2).

Parameter exports are ``.pt`` state dicts (``save_state_dict``,
``load_state_dict``; the JAX package writes msgpack), named
``wav2vec2.pt`` and ``model.pt``.
"""
from __future__ import annotations

import functools
import logging
import os

import numpy as np
import torch

from svt_speechbrain_tpu_torch.core import Brain, Stage
from svt_speechbrain_tpu_torch.utils import transcription_eval
from svt_speechbrain_tpu_torch.utils.amt import AverageMeter, frame2note

logger = logging.getLogger(__name__)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def save_state_dict(module, path):
    """Write ``module``'s state dict to ``path`` (``torch.save``), the
    counterpart of the JAX package's ``save_msgpack`` (``amt.py:39``).

    Example
    -------
    >>> import os, tempfile
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> path = os.path.join(tempfile.mkdtemp(), "model.pt")
    >>> save_state_dict(Linear(2, 3), path)
    >>> sorted(load_state_dict(path))
    ['b', 'w']
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)


def load_state_dict(path):
    """A state dict written by ``save_state_dict``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


class AMTBrainBase(Brain):
    """Shared AMT machinery (``amt.py:62``). Subclasses define
    ``compute_forward``, ``init_optimizers``, the ``annealing`` triples and
    ``_true_frames``; ``hparams`` holds the recipe's criteria, thresholds,
    tolerances, schedulers, ``train_logger``, ``onset_stats``/
    ``offset_stats`` and ``epoch_counter``."""

    #: (scheduler hparams attr, optimizer name, log key)
    annealing = ()

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_only_keys = {"ref_intervals", "ref_pitchs", "cur_utter",
                               "all_utter"}
        self.compute_coff = bool(getattr(self.hparams, "compute_coff", False))
        # "min_loss" (MIR-ST500) or "max_COnPOff_f1" (N20EMv2)
        self.ckpt_policy = getattr(self.hparams, "ckpt_policy", "min_loss")
        self.return_feats = False

    # ------------------------------------------------------------- metrics
    @property
    def metric_names(self):
        names = ["COnPOff", "COnP", "COn"]
        if self.compute_coff:
            names.append("COff")
        return names

    def _reset_song_state(self):
        self.last_utter = 0
        self.song_pred = []
        self.song_feats = []
        for name in self.metric_names:
            for kind in ("precis", "recall", "f1"):
                setattr(self, f"{name}_{kind}", AverageMeter())

    def on_stage_start(self, stage, epoch=None):
        if stage == Stage.TRAIN:
            self.configure_freezing(epoch)
            return
        self.onset_loss_metric = self.hparams.onset_stats()
        self.offset_loss_metric = self.hparams.offset_stats()
        self._reset_song_state()

    def configure_freezing(self, epoch):
        """Linear-probe schedule hook; default none."""

    # -------------------------------------------------------------- losses
    def compute_objectives(self, predictions, batch, stage):
        """4-term masked loss (``amt.py:106-125``)."""
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

    # ------------------------------------------------------- eval stitching
    def _true_frames(self, batch, padded_frames):
        """Frames of real (unpadded) content in this utterance."""
        rel = float(batch["sig"].lengths[0])
        return int(round(rel * padded_frames))

    def on_evaluate_batch_end(self, batch, predictions, loss, stage):
        """Song stitching, decoding and scoring (``amt.py:133-178``)."""
        if stage == Stage.TRAIN:
            return
        onset_logits, offset_logits, octave_logits, class_logits = predictions[:4]
        anno, anno_lens = batch["anno"]
        ids = batch.id
        self.onset_loss_metric.append(
            ids, torch.from_numpy(onset_logits), anno[:, :, 0].float(),
            length=anno_lens, pos_weight=self.hparams.onset_positive_weight)
        self.offset_loss_metric.append(
            ids, torch.from_numpy(offset_logits), anno[:, :, 1].float(),
            length=anno_lens,
            pos_weight=getattr(self.hparams, "offset_positive_weight", 1.0))

        cur_utter = int(batch.cur_utter[0])
        all_utter = int(batch.all_utter[0])
        assert cur_utter == self.last_utter + 1 or cur_utter == 1
        assert onset_logits.shape[0] == 1, \
            "eval expects batch_size 1 in song order"

        frames = self._true_frames(batch, onset_logits.shape[1])
        self.song_pred.append(np.stack([
            _sigmoid(onset_logits[0][:frames]),
            _sigmoid(offset_logits[0][:frames]),
            np.argmax(octave_logits[0][:frames], axis=-1).astype(np.float64),
            np.argmax(class_logits[0][:frames], axis=-1).astype(np.float64),
        ], axis=-1))
        if self.return_feats and len(predictions) > 4:
            self.song_feats.append(np.asarray(predictions[-1][0][:frames]))

        if cur_utter == all_utter:
            est_result = frame2note(
                np.concatenate(self.song_pred, axis=0),
                onset_thres=self.hparams.onset_threshold,
                offset_thres=self.hparams.offset_threshold,
                frame_size=1 / self.hparams.frame_rate)
            est_np = np.array(est_result) if est_result else np.zeros((0, 3))
            self.on_song_end(batch, est_np)
            self._score_song(
                est_np, np.asarray(batch.ref_intervals.data[0], np.float64),
                np.asarray(batch.ref_pitchs.data[0], np.float64))
            self.song_pred = []
            self.song_feats = []
        self.last_utter = cur_utter

    def on_song_end(self, batch, est_np):
        """Hook at a song's end (feature and prediction dumps)."""

    def _score_song(self, est_np, ref_intervals, ref_pitchs):
        """COnPOff/COnP/COn (and COff) of one song (``amt.py:183-207``);
        a song without a detected note scores 0 everywhere."""
        if est_np.shape[0] == 0:
            logger.info("There are no detected note events! "
                        "All metrics for this song are set as zero!")
            for name in self.metric_names:
                for kind in ("precis", "recall", "f1"):
                    getattr(self, f"{name}_{kind}").update(0.0)
            return
        raw = transcription_eval.evaluate(
            ref_intervals, transcription_eval.midi_to_hz(ref_pitchs),
            est_np[:, :2], transcription_eval.midi_to_hz(est_np[:, 2]),
            onset_tolerance=self.hparams.onset_tolerance,
            pitch_tolerance=self.hparams.pitch_tolerance)
        key_map = {
            "COnPOff": ("Precision", "Recall", "F-measure"),
            "COnP": ("Precision_no_offset", "Recall_no_offset",
                     "F-measure_no_offset"),
            "COn": ("Onset_Precision", "Onset_Recall", "Onset_F-measure"),
            "COff": ("Offset_Precision", "Offset_Recall", "Offset_F-measure"),
        }
        for name in self.metric_names:
            p, r, f = key_map[name]
            getattr(self, f"{name}_precis").update(raw[p])
            getattr(self, f"{name}_recall").update(raw[r])
            getattr(self, f"{name}_f1").update(raw[f])

    # --------------------------------------------------------- stage ends
    def on_stage_end(self, stage, stage_loss, epoch=None):
        """Train: keep the stats. Valid: anneal, log, checkpoint by the
        policy. Test: log (``amt.py:210-247``)."""
        stage_stats = {"loss": stage_loss}
        if stage == Stage.TRAIN:
            self.train_stats = stage_stats
            return
        for name in self.metric_names:
            for kind in ("precis", "recall", "f1"):
                stage_stats[f"{name}_{kind}"] = getattr(
                    self, f"{name}_{kind}").avg

        if stage == Stage.VALID:
            meta = {"epoch": epoch}
            for sched_attr, opt_name, log_key in self.annealing:
                old_lr, new_lr = getattr(self.hparams, sched_attr)(
                    stage_stats["loss"])
                self.set_learning_rate(opt_name, new_lr)
                meta[log_key] = old_lr
            self.hparams.train_logger.log_stats(
                stats_meta=meta,
                train_stats=self.train_stats,
                valid_stats={
                    "loss": stage_loss,
                    "onset_loss": self.onset_loss_metric.summarize("average"),
                    "offset_loss": self.offset_loss_metric.summarize("average"),
                    **{k: v for k, v in stage_stats.items() if k != "loss"},
                })
            if self.checkpointer is not None:
                if self.ckpt_policy == "max_COnPOff_f1":
                    self.checkpointer.save_and_keep_only(
                        meta={"COnPOff_f1": stage_stats["COnPOff_f1"]},
                        max_keys=["COnPOff_f1"])
                else:
                    self.checkpointer.save_and_keep_only(
                        meta={"loss": stage_stats["loss"]}, min_keys=["loss"])
        elif stage == Stage.TEST:
            self.hparams.train_logger.log_stats(
                stats_meta={"Epoch loaded": self.hparams.epoch_counter.current},
                test_stats={"loss": stage_loss,
                            **{f"{n}_f1": stage_stats[f"{n}_f1"]
                               for n in self.metric_names}})


class AudioAMT(AMTBrainBase):
    """wav2vec2 + linear head audio AMT (``amt.py:250``).

    ``hparams`` holds, as the recipe's yaml: ``pitch_octave_num``,
    ``onset_positive_weight`` (and optionally ``offset_positive_weight``),
    ``onset_criterion``/``offset_criterion`` (``bce_loss`` partials),
    ``octave_criterion``/``pitch_criterion`` (``nll_loss`` partials),
    ``log_softmax`` (``Softmax(apply_log=True)``), ``lr``, ``lr_wav2vec``
    and ``linear_prob_epochs``; evaluation adds the thresholds and
    tolerances, ``frame_rate``, the two NewBob schedulers, ``train_logger``,
    ``onset_stats``/``offset_stats`` and ``epoch_counter``. ``modules`` are
    ``wav2vec2`` (``HuggingFaceWav2Vec2``) and ``model`` (``Linear``).
    """

    annealing = (("lr_annealing_wav2vec", "wav2vec", "lr_wav2vec"),
                 ("lr_annealing_model", "model", "lr_model"))

    def compute_forward(self, batch, stage, rng=None):
        wavs, wav_lens = batch["sig"]
        if stage == Stage.TRAIN:
            # as the reference trains: padding attended, batch-wide norms
            feats = self.modules.wav2vec2(wavs, rng=rng, train=True,
                                          row_mask=batch.get("valid_rows"))
        else:
            # exact lengths: at batch 1 equal to running the unpadded row
            feats = self.modules.wav2vec2(wavs, wav_lens=wav_lens)
        logits = self.modules.model(feats)
        n_oct = self.hparams.pitch_octave_num
        out = (logits[:, :, 0], logits[:, :, 1],
               logits[:, :, 2:3 + n_oct], logits[:, :, 3 + n_oct:], wav_lens)
        return out + (feats,) if self.return_feats else out

    def _true_frames(self, batch, padded_frames):
        # frames from the conv striding over the true sample count
        wav_rel = float(batch["sig"].lengths[0])
        true_samples = int(round(wav_rel * batch["sig"].data.shape[1]))
        return self.modules.wav2vec2.config.output_length(true_samples)

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

    def on_fit_start(self):
        """Converted HF weights found at the bridge's ``save_path``, then
        the ``pretrain_folder``'s exports when ``pretrain`` is set, then the
        optimizers and the newest checkpoint, which takes precedence over
        both (the JAX brain loads the first two after recovery,
        ``amt.py:298-311``)."""
        pretrained = self.modules.wav2vec2.load_pretrained()
        if pretrained is not None:
            logger.info("Loaded converted HF wav2vec2 weights")
            self.modules.wav2vec2.load_state_dict(pretrained)
        if getattr(self.hparams, "pretrain", False):
            folder = self.hparams.pretrain_folder
            logger.info(f"Load wav2vec 2.0 model weights from the folder: "
                        f"{folder}")
            self.modules.wav2vec2.load_state_dict(
                load_state_dict(os.path.join(folder, "wav2vec2.pt")))
            head_path = os.path.join(folder, "model.pt")
            if os.path.exists(head_path):
                self.modules.model.load_state_dict(load_state_dict(head_path))
        super().on_fit_start()

    def on_evaluate_start(self, max_key=None, min_key=None):
        super().on_evaluate_start(max_key=max_key, min_key=min_key)
        # the parameter export that feeds the fusion stage
        # (``amt.py:313-321``)
        if getattr(self.hparams, "save_model", False):
            folder = self.hparams.save_model_folder
            save_state_dict(self.modules.wav2vec2,
                            os.path.join(folder, "wav2vec2.pt"))
            save_state_dict(self.modules.model,
                            os.path.join(folder, "model.pt"))
            logger.info(f"Save wav2vec 2.0 and classifier to the folder: "
                        f"{folder}")

    def on_song_end(self, batch, est_np):
        """Feature dump at a song's end (``amt.py:323-338``)."""
        if not self.return_feats or not self.song_feats:
            return
        feats = np.concatenate(self.song_feats, axis=0)
        wav_path = batch.wav[0] if hasattr(batch, "wav") else None
        if wav_path is None:
            return
        folder = os.path.join(os.path.dirname(wav_path), "noise_data")
        if getattr(self.hparams, "add_noise", False):
            path = os.path.join(folder, self.hparams.noise_type,
                                f"SNR_{self.hparams.snr_db}dB_feats.npy")
        else:
            path = os.path.join(folder, "clean_feats.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, feats)


class VideoAMT(AMTBrainBase):
    """AV-HuBERT visual encoder + linear head video AMT (``amt.py:341``).

    ``modules`` are ``encoder`` (``FairseqAVHubert``, video only: the audio
    stream is zero-filled) and ``head`` (``Linear``); batches hold ``sig``,
    the lip ROIs (B, T, H, W, 1) at 50 frames a second, one frame per
    annotation frame. Adam trains the encoder at ``lr_encoder``, Adadelta
    (rho 0.95, eps 1e-8) the head at ``lr``, each annealed by its NewBob
    scheduler (``lr_annealing_encoder``, ``lr_annealing_head``). The first
    ``linear_prob_epochs`` epochs freeze the encoder's parameters only: a
    training step still runs it in train mode, as the JAX engine's loss
    does (``core.py:604-612``), so its BatchNorm statistics update and its
    dropouts stay on. Evaluation reads the running statistics.
    ``return_feats`` adds the encoder's features to the predictions, and
    each song's go to ``noise_data/video_feats.npy`` beside its video.
    """

    annealing = (("lr_annealing_encoder", "encoder", "lr_encoder"),
                 ("lr_annealing_head", "head", "lr_head"))

    def compute_forward(self, batch, stage, rng=None):
        video, video_lens = batch["sig"]
        feats = self.modules.encoder({"video": video, "audio": None},
                                     train=stage == Stage.TRAIN, rng=rng)
        logits = self.modules.head(feats)
        n_oct = self.hparams.pitch_octave_num
        out = (logits[:, :, 0], logits[:, :, 1],
               logits[:, :, 2:3 + n_oct], logits[:, :, 3 + n_oct:],
               video_lens)
        return out + (feats,) if self.return_feats else out

    def configure_freezing(self, epoch):
        if epoch is not None and epoch <= getattr(self.hparams,
                                                  "linear_prob_epochs", 0):
            logger.info("Stage for linear probing")
            self.set_frozen_modules(["encoder"])
        else:
            logger.info("Stage for full finetuning")
            self.set_frozen_modules([])

    def init_optimizers(self):
        self.add_optimizer("encoder", torch.optim.Adam, ["encoder"],
                           lr=self.hparams.lr_encoder)
        self.add_optimizer(
            "head", functools.partial(torch.optim.Adadelta, rho=0.95,
                                      eps=1e-8),
            ["head"], lr=self.hparams.lr)

    def on_fit_start(self):
        """A converted fairseq checkpoint found at the encoder's source
        (parameters and BatchNorm statistics), then the optimizers and the
        newest checkpoint, which takes precedence (the JAX brain loads the
        pretrained weights after recovery, ``amt.py:375-382``)."""
        pretrained = self.modules.encoder.load_pretrained()
        if pretrained is not None:
            logger.info("Loaded converted AV-HuBERT weights")
            self.modules.encoder.load_state_dict(pretrained)
        super().on_fit_start()

    def on_song_end(self, batch, est_np):
        """Feature dump at a song's end (``amt.py:384-395``)."""
        if not self.return_feats or not self.song_feats:
            return
        video_path = batch.video[0] if hasattr(batch, "video") else None
        if video_path is None:
            return
        path = os.path.join(os.path.dirname(video_path), "noise_data",
                            "video_feats.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, np.concatenate(self.song_feats, axis=0))


class FusionAMT(AMTBrainBase):
    """Stage-2 RCA fusion over pre-extracted features (``amt.py:396``): the
    AV recipe, and with ``zero_video`` the audio-only control whose video
    stream is zeros.

    ``modules`` are ``fusion`` (``models.fusion.FusionRCA``) and ``head``
    (``Linear``); batches hold ``sig1`` (audio features, B x T x d) and
    ``sig2`` (video features, aligned to them), and ``audio`` (the clean
    dump's path, for the prediction dumps). One Adadelta (rho 0.95, eps
    1e-8) at ``lr`` trains both modules. With ``pretrain`` the head starts
    from ``pretrain_folder``'s ``model.pt`` (the port's stage-1 export) or,
    failing that, ``model.msgpack`` (a JAX export, through
    ``convert_jax``); a checkpoint of the run, when there is one, wins over
    it (the JAX brain loads the head after recovery).
    """

    annealing = (("lr_annealing_model", "model", "lr_model"),)

    def __init__(self, *args, zero_video=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.zero_video = zero_video

    def compute_forward(self, batch, stage, rng=None):
        audio_feats, wav_lens = batch["sig1"]
        video_feats = batch["sig2"].data
        if self.zero_video:
            video_feats = torch.zeros_like(video_feats)
        feats = self.modules.fusion(audio_feats, video_feats, rng=rng,
                                    train=stage == Stage.TRAIN)
        logits = self.modules.head(feats)
        n_oct = self.hparams.pitch_octave_num
        return (logits[:, :, 0], logits[:, :, 1],
                logits[:, :, 2:3 + n_oct], logits[:, :, 3 + n_oct:], wav_lens)

    def _true_frames(self, batch, padded_frames):
        rel = float(batch["sig1"].lengths[0])
        return int(round(rel * batch["sig1"].data.shape[1]))

    def init_optimizers(self):
        self.add_optimizer(
            "model", functools.partial(torch.optim.Adadelta, rho=0.95,
                                       eps=1e-8),
            ["fusion", "head"], lr=self.hparams.lr)

    def on_fit_start(self):
        if getattr(self.hparams, "pretrain", False):
            folder = self.hparams.pretrain_folder
            pt = os.path.join(folder, "model.pt")
            msgpack = os.path.join(folder, "model.msgpack")
            if os.path.exists(pt):
                logger.info(f"Load classifier model weights from: {pt}")
                self.modules.head.load_state_dict(load_state_dict(pt))
            elif os.path.exists(msgpack):
                from svt_speechbrain_tpu_torch.convert_jax import (
                    load_module_tree, load_msgpack)

                logger.info(f"Load classifier model weights from: {msgpack}")
                load_module_tree(self.modules.head, load_msgpack(msgpack))
            else:
                logger.warning(f"pretrain=True but {pt} not found")
        super().on_fit_start()

    def on_song_end(self, batch, est_np):
        """Per-song note dump: ``clean_{tag}_pred.npy`` beside the clean
        feature dump, or ``<noise_type>/SNR_<x>dB_{tag}_pred.npy`` with
        ``add_noise``; ``tag`` is "av", or "audio" for the control
        (``amt.py:439-455``)."""
        audio_path = batch.audio[0] if hasattr(batch, "audio") else None
        if audio_path is None:
            return
        tag = "audio" if self.zero_video else "av"
        folder = os.path.dirname(audio_path)
        if getattr(self.hparams, "add_noise", False):
            path = os.path.join(folder, self.hparams.noise_type,
                                f"SNR_{self.hparams.snr_db}dB_{tag}_pred.npy")
        else:
            path = os.path.join(folder, f"clean_{tag}_pred.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, est_np)

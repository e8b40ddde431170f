"""AV-HuBERT (port of ``svt_speechbrain_tpu/models/avhubert.py``): the
encoder, its pretraining, the fairseq wav2vec bridges and the AV dataset.

- dual-stream feature extractors: video = ``ResEncoder`` (Conv3d +
  ResNet-18) + linear proj, audio = linear proj of precomputed features;
- a missing modality zero-filled at the encoder width;
- modality fuse by channel concat (default) or add → ``layer_norm`` →
  ``post_extract_proj`` (2048 → 1024 for concat);
- the wav2vec2 encoder of the port (``ConvPositionalEmbedding`` and
  ``TransformerLayer`` of ``models/wav2vec2.py``), run without key lengths
  (every frame attends to every frame, padding included): pre-LN layers
  then ``encoder_ln`` for AV-HuBERT large (``layer_norm_first``), or
  ``encoder_ln`` then post-LN layers for AV-HuBERT base
  (``AVHubertConfig.base()``).

The BatchNorm running statistics of the visual frontend are buffers of the
modules, updated in place by a training forward (the JAX package threads
them as a state tree).

``AVHubertPretrain`` is the masked-prediction pretraining of Hsu et al.:
the fused features with masked frames replaced by a learned embedding, the
encoder, and cosine logits against cluster-label embeddings, with separate
masked and unmasked cross-entropies. ``FairseqWav2Vec2`` and
``FairseqWav2Vec1`` are the fairseq wav2vec encoders;
``load_audio_visual``/``AVHubertDataset`` read an AV-HuBERT tsv manifest
and its label files.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import os

import numpy as np
import torch
from torch import nn

from svt_speechbrain_tpu_torch.models.resnet import ResEncoder
from svt_speechbrain_tpu_torch.models.wav2vec2 import HuggingFaceWav2Vec2
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    ConvPositionalEmbedding, TransformerLayer, Wav2Vec2Config, _drop)
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (LayerNorm,
                                                          global_layer_norm)
from svt_speechbrain_tpu_torch.processing.video import compute_mask_indices


@dataclasses.dataclass
class AVHubertConfig:
    """The fine-tune/inference subset of the reference's ``AVHubertConfig``
    (``avhubert.py:40``). Defaults = AV-HuBERT large."""

    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_embed_dim: int = 4096
    encoder_attention_heads: int = 16
    audio_feat_dim: int = 104
    video_feat_dim: int = 512
    modality_fuse: str = "concat"  # "concat" | "add"
    conv_pos: int = 128
    conv_pos_groups: int = 16
    layer_norm_first: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    relu_type: str = "prelu"

    @classmethod
    def large(cls):
        return cls()

    @classmethod
    def base(cls):
        return cls(encoder_layers=12, encoder_embed_dim=768,
                   encoder_ffn_embed_dim=3072, encoder_attention_heads=12,
                   layer_norm_first=False)

    def encoder_cfg(self) -> Wav2Vec2Config:
        return Wav2Vec2Config(
            hidden_size=self.encoder_embed_dim,
            num_layers=self.encoder_layers,
            num_heads=self.encoder_attention_heads,
            ffn_size=self.encoder_ffn_embed_dim,
            num_conv_pos_embeddings=self.conv_pos,
            num_conv_pos_embedding_groups=self.conv_pos_groups,
            do_stable_layer_norm=self.layer_norm_first,
            hidden_dropout=self.dropout,
            attention_dropout=self.attention_dropout,
            activation_dropout=self.activation_dropout)


class AudioSubModel(nn.Module):
    """Audio stream: a linear proj of precomputed features
    (``avhubert.py:85``), (B, T, audio_feat_dim) → (B, T, D)."""

    def __init__(self, config: AVHubertConfig):
        super().__init__()
        self.proj = Linear(config.encoder_embed_dim, config.audio_feat_dim)

    def forward(self, x):
        return self.proj(x)


class VideoSubModel(nn.Module):
    """Video stream: ``ResEncoder`` + linear proj (``avhubert.py:100``),
    (B, T, H, W, 1) → (B, T, D)."""

    def __init__(self, config: AVHubertConfig):
        super().__init__()
        self.resnet = ResEncoder(relu_type=config.relu_type)
        self.proj = Linear(config.encoder_embed_dim, config.video_feat_dim)

    def forward(self, x, train=False):
        return self.proj(self.resnet(x, train=train))


class AVHubertModel(nn.Module):
    """Dual-stream AV-HuBERT encoder (``avhubert.py:120``).

    Example
    -------
    >>> import torch
    >>> cfg = AVHubertConfig(encoder_layers=1, encoder_embed_dim=16,
    ...                      encoder_ffn_embed_dim=32,
    ...                      encoder_attention_heads=4, audio_feat_dim=10,
    ...                      modality_fuse="concat", conv_pos=8,
    ...                      conv_pos_groups=2)
    >>> m = AVHubertModel(cfg)
    >>> m.extract_finetune({"audio": torch.ones(2, 7, 10)}).shape
    torch.Size([2, 7, 16])
    """

    def __init__(self, config: AVHubertConfig = None):
        super().__init__()
        self.config = c = config or AVHubertConfig.large()
        enc_cfg = c.encoder_cfg()
        self.enc_cfg = enc_cfg
        self.feature_extractor_audio = AudioSubModel(c)
        self.feature_extractor_video = VideoSubModel(c)
        self.embed = (c.encoder_embed_dim * 2 if c.modality_fuse == "concat"
                      else c.encoder_embed_dim)
        self.layer_norm = LayerNorm(self.embed)
        self.post_extract_proj = (Linear(c.encoder_embed_dim, self.embed)
                                  if self.embed != c.encoder_embed_dim
                                  else None)
        self.pos_conv = ConvPositionalEmbedding(enc_cfg)
        self.encoder_ln = LayerNorm(c.encoder_embed_dim)
        self.layers = nn.ModuleList(TransformerLayer(enc_cfg)
                                    for _ in range(c.encoder_layers))
        # pretraining's mask embedding, kept for checkpoint compatibility
        self.mask_emb = nn.Parameter(torch.zeros(c.audio_feat_dim))

    def extract_finetune(self, source, train=False, rng=None):
        """``source``: a dict with "video" (B, T, H, W, 1) and/or "audio"
        (B, T, F); a missing modality is zero-filled. Returns (B, T, D).
        ``train`` puts the BatchNorms in training mode; with a ``StepRNG``
        it also turns on the dropouts (``avhubert.py:174-224``)."""
        c = self.config
        audio, video = source.get("audio"), source.get("video")
        if audio is None and video is None:
            raise ValueError("source holds neither audio nor video")
        feats_audio = feats_video = None
        if video is not None:
            feats_video = self.feature_extractor_video(video, train=train)
        if audio is not None:
            feats_audio = self.feature_extractor_audio(audio)
        if feats_audio is None:
            feats_audio = torch.zeros_like(feats_video)
        if feats_video is None:
            feats_video = torch.zeros_like(feats_audio)
        if c.modality_fuse == "concat":
            features = torch.cat([feats_audio, feats_video], dim=-1)
        else:
            features = feats_audio + feats_video
        features = self.layer_norm(features)
        if self.post_extract_proj is not None:
            features = self.post_extract_proj(features)
        features = _drop(features, c.dropout_input, rng, train)
        x = features + self.pos_conv(features)
        if not c.layer_norm_first:
            x = self.encoder_ln(x)
        x = _drop(x, c.dropout, rng, train)
        for layer in self.layers:
            x = layer(x, rng=rng, train=train)
        return self.encoder_ln(x) if c.layer_norm_first else x


class FairseqAVHubert(nn.Module):
    """The bridge with the reference's fairseq-interface semantics
    (``avhubert.py:227``): ``freeze`` runs the encoder without gradients,
    with its BatchNorms in eval mode and no dropout; ``output_norm``
    normalizes the output over all of its elements, padding included;
    ``arch_overrides`` replace config fields; ``load_pretrained`` converts
    a local fairseq checkpoint.

    Example
    -------
    >>> import torch
    >>> enc = FairseqAVHubert(arch_overrides=dict(
    ...     encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
    ...     encoder_attention_heads=4, conv_pos=8, conv_pos_groups=2),
    ...     output_norm=True)
    >>> enc({"video": torch.ones(1, 2, 32, 32, 1)}).shape
    torch.Size([1, 2, 16])
    >>> enc.load_pretrained() is None        # no checkpoint at the source
    True
    """

    def __init__(self, source=None, save_path=None,
                 config: AVHubertConfig = None, freeze=False,
                 output_norm=False, arch_overrides=None):
        super().__init__()
        if isinstance(source, AVHubertConfig):
            config, source = source, None
        config = config or AVHubertConfig.large()
        if arch_overrides:
            config = dataclasses.replace(config, **arch_overrides)
        self.config = config
        self.source = source
        self.save_path = save_path
        self.freeze = freeze
        self.output_norm = output_norm
        self.model = AVHubertModel(config)

    def forward(self, source, train=False, rng=None):
        if self.freeze:
            with torch.no_grad():
                out = self.model.extract_finetune(source)
        else:
            out = self.model.extract_finetune(source, train=train, rng=rng)
        if self.output_norm:
            out = global_layer_norm(out)
        return out

    def extract_features(self, source, **kw):
        return self(source, **kw)

    def load_pretrained(self):
        """The bridge's state dict (parameters and BatchNorm statistics)
        converted from a local fairseq AV-HuBERT checkpoint at ``save_path``
        or ``source``, or None when neither is a file; nothing is
        downloaded."""
        from svt_speechbrain_tpu_torch.models.convert_fairseq import (
            load_avhubert)

        for candidate in (self.save_path, self.source):
            if candidate and os.path.exists(str(candidate)):
                state = load_avhubert(candidate, self.config)
                return {f"model.{k}": v for k, v in state.items()}
        return None


class AVHubertPretrain(nn.Module):
    """AV-HuBERT masked-prediction pretraining (``avhubert.py:283``): the
    two streams fused, masked frames replaced by ``mask_emb``, the encoder,
    ``final_proj``, and cosine logits against ``label_embs`` over
    ``logit_temp``; the loss weighs the masked and unmasked cross-entropies.
    A missing modality is zeros shaped like the other one. The visual
    frontend's BatchNorm statistics update in its buffers in training.
    There is no input dropout and none after the positional conv, as in the
    JAX forward; the layers drop out with a ``StepRNG``.

    Example
    -------
    >>> import numpy as np, torch
    >>> cfg = AVHubertConfig(encoder_layers=1, encoder_embed_dim=16,
    ...                      encoder_ffn_embed_dim=32,
    ...                      encoder_attention_heads=4, audio_feat_dim=10,
    ...                      conv_pos=8, conv_pos_groups=2)
    >>> model = AVHubertPretrain(cfg, num_classes=5, final_dim=8)
    >>> mask = model.sample_masks(2, 30, np.random.default_rng(0))
    >>> loss, aux = model({"audio": torch.ones(2, 30, 10)},
    ...                   torch.zeros(2, 30, dtype=torch.long), mask)
    >>> sorted(aux)
    ['masked_acc', 'masked_loss', 'unmasked_loss']
    """

    def __init__(self, config: AVHubertConfig = None, num_classes=500,
                 final_dim=256, masked_weight=1.0, unmasked_weight=0.0,
                 logit_temp=0.1, mask_prob=0.8, mask_length=10):
        super().__init__()
        self.config = c = config or AVHubertConfig.large()
        self.model = AVHubertModel(c)
        self.final_proj = Linear(final_dim, c.encoder_embed_dim)
        self.label_embs = nn.Parameter(torch.zeros(num_classes, final_dim))
        self.mask_emb = nn.Parameter(torch.zeros(c.encoder_embed_dim))
        self.num_classes = num_classes
        self.final_dim = final_dim
        self.masked_weight = masked_weight
        self.unmasked_weight = unmasked_weight
        self.logit_temp = logit_temp
        self.mask_prob = mask_prob
        self.mask_length = mask_length

    def sample_masks(self, batch_size, num_frames, rng=None):
        """Host-side span masks (B, T) (``min_masks=1``)."""
        rng = rng or np.random.default_rng()
        mask, *_ = compute_mask_indices((batch_size, num_frames), None,
                                        self.mask_prob, self.mask_length,
                                        rng=rng, min_masks=1)
        return mask

    def forward(self, source, targets, mask, rng=None, train=False):
        """``source``: "audio" (B, T, F) and/or "video" (B, T, H, W, 1);
        ``targets`` (B, T) cluster ids; ``mask`` (B, T) bool, numpy or a
        tensor. Returns (loss, aux)."""
        c = self.config
        m = self.model
        audio, video = source.get("audio"), source.get("video")
        if audio is None and video is None:
            raise ValueError("source holds neither audio nor video")
        feats_video = (m.feature_extractor_video(video, train=train)
                       if video is not None else None)
        feats_audio = (m.feature_extractor_audio(audio)
                       if audio is not None else None)
        if feats_audio is None:
            feats_audio = torch.zeros_like(feats_video)
        if feats_video is None:
            feats_video = torch.zeros_like(feats_audio)
        if c.modality_fuse == "concat":
            features = torch.cat([feats_audio, feats_video], dim=-1)
        else:
            features = feats_audio + feats_video
        features = m.layer_norm(features)
        if m.post_extract_proj is not None:
            features = m.post_extract_proj(features)
        t = features.shape[1]
        mask = torch.as_tensor(mask, device=features.device)[:, :t].bool()
        x = torch.where(mask[..., None], self.mask_emb.to(features.dtype),
                        features)
        x = x + m.pos_conv(x)
        if not c.layer_norm_first:
            x = m.encoder_ln(x)
        for layer in m.layers:
            x = layer(x, rng=rng, train=train)
        if c.layer_norm_first:
            x = m.encoder_ln(x)

        proj = self.final_proj(x)                             # (B, T, F)
        p = proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
                    + 1e-8)
        embs = self.label_embs.to(p.dtype)
        e = embs / (torch.linalg.vector_norm(embs, dim=-1, keepdim=True)
                    + 1e-8)
        logits = (p @ e.t()) / self.logit_temp                # (B, T, C)
        logp = torch.log_softmax(logits, dim=-1)
        targets = torch.as_tensor(targets, device=logp.device)[:, :t].long()
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        mask_f = mask.to(nll.dtype)
        n_masked = torch.clamp(mask_f.sum(), min=1.0)
        masked_loss = (nll * mask_f).sum() / n_masked
        unmasked_loss = (nll * (1 - mask_f)).sum() / torch.clamp(
            (1 - mask_f).sum(), min=1.0)
        loss = (self.masked_weight * masked_loss
                + self.unmasked_weight * unmasked_loss)
        acc = ((logits.argmax(-1) == targets).to(nll.dtype)
               * mask_f).sum() / n_masked
        return loss, {"masked_loss": masked_loss,
                      "unmasked_loss": unmasked_loss, "masked_acc": acc}


# the reference's fairseq-facing names (``avhubert.py:407-409``)
SubModel = AudioSubModel
FairseqAVHubertFinetune = FairseqAVHubert
FairseqAVHubertPretrain = AVHubertPretrain


class FairseqWav2Vec2(nn.Module):
    """wav2vec 2.0 from a fairseq checkpoint (``avhubert.py:412``): the
    ``HuggingFaceWav2Vec2`` bridge (lv60 unless ``config``) under fairseq's
    key names; ``load_pretrained`` converts a local fairseq ``.pt``.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    ...     TINY_ARCH, Wav2Vec2Config)
    >>> enc = FairseqWav2Vec2(config=Wav2Vec2Config(**TINY_ARCH))
    >>> enc(torch.ones(1, 3200)).shape, enc.load_pretrained()
    (torch.Size([1, 9, 64]), None)
    """

    def __init__(self, pretrained_path=None, output_norm=True, freeze=False,
                 config=None):
        super().__init__()
        from svt_speechbrain_tpu_torch.models.wav2vec2 import Wav2Vec2Config

        self.pretrained_path = pretrained_path
        self.bridge = HuggingFaceWav2Vec2(
            config=config or Wav2Vec2Config.large_lv60(),
            output_norm=output_norm, freeze=freeze)

    @property
    def config(self):
        return self.bridge.config

    def load_pretrained(self):
        """This module's state dict converted from the local fairseq
        checkpoint at ``pretrained_path``, or None when there is none."""
        from svt_speechbrain_tpu_torch.models.convert_fairseq import (
            convert_wav2vec2_fairseq_state_dict, load_fairseq_state_dict)

        if self.pretrained_path and os.path.exists(self.pretrained_path):
            sd = load_fairseq_state_dict(self.pretrained_path)
            state = convert_wav2vec2_fairseq_state_dict(sd, self.config)
            return {f"bridge.encoder.{k}": v for k, v in state.items()}
        return None

    def forward(self, wav, **kwargs):
        return self.bridge(wav, **kwargs)

    def extract_features(self, wav, **kwargs):
        return self(wav, **kwargs)


class FairseqWav2Vec1(nn.Module):
    """wav2vec 1.0 (``avhubert.py:454``): a conv feature encoder
    (``feat<i>``, valid padding) and a causal conv context network
    (``ctx<i>``), ReLU after each conv, no transformer.

    Example
    -------
    >>> import torch
    >>> FairseqWav2Vec1(context_layers=2, embedding_dim=8)(
    ...     torch.ones(1, 1600)).shape
    torch.Size([1, 8, 8])
    """

    def __init__(self, conv_dim=(64,) * 5, conv_kernel=(10, 8, 4, 4, 4),
                 conv_stride=(5, 4, 2, 2, 2), context_layers=9,
                 context_kernel=3, embedding_dim=512):
        super().__init__()
        self.num_feature = len(conv_dim)
        self.num_context = context_layers
        in_ch = 1
        for i, (dim, k, st) in enumerate(zip(conv_dim, conv_kernel,
                                             conv_stride)):
            self.add_module(f"feat{i}", Conv1d(dim, k, in_ch, stride=st,
                                               padding="valid"))
            in_ch = dim
        for i in range(context_layers):
            self.add_module(f"ctx{i}", Conv1d(
                embedding_dim, context_kernel,
                in_ch if i == 0 else embedding_dim, padding="causal"))

    def forward(self, wav):
        x = wav[..., None]
        for i in range(self.num_feature):
            x = torch.relu(getattr(self, f"feat{i}")(x))
        for i in range(self.num_context):
            x = torch.relu(getattr(self, f"ctx{i}")(x))
        return x


def load_label(label_path, inds, tot):
    """The label lines of ``inds`` (``avhubert.py:492``)."""
    with open(label_path) as f:
        labels = [line.rstrip() for line in f]
    assert len(labels) == tot, \
        f"number of labels does not match ({len(labels)} != {tot})"
    return [labels[i] for i in inds]


def load_label_offset(label_path, inds, tot):
    """The byte (start, end) of the label lines of ``inds``
    (``avhubert.py:501``)."""
    with open(label_path) as f:
        code_lengths = [len(line.encode("utf-8")) for line in f]
    assert len(code_lengths) == tot, \
        f"number of labels does not match ({len(code_lengths)} != {tot})"
    offsets = list(itertools.accumulate([0] + code_lengths))
    return [(offsets[i], offsets[i + 1]) for i in inds]


def verify_label_lengths(audio_sizes, audio_rate, label_path, label_rate,
                         inds, tot, tol=0.1):
    """Warn where the audio's and the frame labels' durations differ by
    more than ``tol`` seconds; returns how many do (``avhubert.py:514``)."""
    if label_rate < 0:
        return 0
    with open(label_path) as f:
        lengths = [len(line.rstrip().split()) for line in f]
    assert len(lengths) == tot
    num_invalid = 0
    for i, ind in enumerate(inds):
        dur_from_audio = audio_sizes[i] / audio_rate
        dur_from_label = lengths[ind] / label_rate
        if abs(dur_from_audio - dur_from_label) > tol:
            logging.getLogger(__name__).warning(
                "audio and label duration differ: audio=%.3f label=%.3f",
                dur_from_audio, dur_from_label)
            num_invalid += 1
    return num_invalid


def load_audio_visual(manifest_path, max_keep, min_keep, frame_rate,
                      label_paths=None, label_rates=None, tol=0.1):
    """An AV-HuBERT tsv manifest (a root line, then ``id<TAB>video<TAB>
    audio<TAB>n_video_frames<TAB>n_audio_samples`` rows) filtered by audio
    length (``avhubert.py:538``): (root, [(video, audio)], inds, tot,
    sizes)."""
    names, inds, sizes = [], [], []
    with open(manifest_path) as f:
        root = f.readline().strip()
        for ind, line in enumerate(f):
            items = line.strip().split("\t")
            sz = int(items[-1])
            if min_keep is not None and sz < min_keep:
                continue
            if max_keep is not None and sz > max_keep:
                continue
            names.append((items[1], items[2]))
            inds.append(ind)
            sizes.append(sz)
    tot = ind + 1
    if label_paths is not None:
        for lp, lr in zip(label_paths,
                          label_rates or [frame_rate] * len(label_paths)):
            verify_label_lengths(sizes, 16000, lp, lr, inds, tot, tol=tol)
    return root, names, inds, tot, sizes


class AVHubertDataset:
    """The items of a tsv manifest and its label files
    (``avhubert.py:564``): "id", "audio" samples and "video" frames (through
    ``video_transform``) where their files exist, and "label<i>"."""

    def __init__(self, manifest_path, sample_rate=16000, label_paths=(),
                 label_rates=(), max_keep_sample_size=None,
                 min_keep_sample_size=None, video_transform=None):
        self.root, self.names, self.inds, tot, self.sizes = load_audio_visual(
            manifest_path, max_keep_sample_size, min_keep_sample_size,
            sample_rate, label_paths=list(label_paths) or None,
            label_rates=list(label_rates) or None)
        self.sample_rate = sample_rate
        self.video_transform = video_transform
        self.labels = [load_label(lp, self.inds, tot) for lp in label_paths]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index):
        from svt_speechbrain_tpu_torch.dataio.dataio import read_audio
        from svt_speechbrain_tpu_torch.processing.video import load_video

        video_name, audio_name = self.names[index]
        item = {"id": index}
        audio_path = os.path.join(self.root, audio_name)
        if os.path.exists(audio_path):
            item["audio"] = read_audio(audio_path)
        video_path = os.path.join(self.root, video_name)
        if os.path.exists(video_path):
            video = load_video(video_path)
            if self.video_transform is not None:
                video = self.video_transform(video)
            item["video"] = video
        for i, labels in enumerate(self.labels):
            item[f"label{i}"] = labels[index]
        return item

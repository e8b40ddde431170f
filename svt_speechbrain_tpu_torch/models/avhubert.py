"""AV-HuBERT encoder, the fine-tune half (port of
``svt_speechbrain_tpu/models/avhubert.py:40-282``).

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
them as a state tree). The pretraining half (``AVHubertPretrain`` and its
helpers) is not ported.
"""
from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from svt_speechbrain_tpu_torch.models.resnet import ResEncoder
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    ConvPositionalEmbedding, TransformerLayer, Wav2Vec2Config, _drop)
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (LayerNorm,
                                                          global_layer_norm)


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

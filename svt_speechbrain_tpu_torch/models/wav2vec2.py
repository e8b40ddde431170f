"""wav2vec 2.0 encoder (port of ``svt_speechbrain_tpu/models/wav2vec2.py``).

The port covers the wav2vec2-large-lv60 path, for serving and training:

- the "layer"-norm conv extractor (``ConvFeatureExtractor``), dispatched to
  the CUDA conv-frontend kernel when ``ops.conv_frontend.can_fuse`` holds
  and the frontend is fused (not training, or a frozen extractor);
- feature projection (LayerNorm → Linear);
- the weight-normed grouped positional conv (k=128, groups=16) + GELU;
- pre-LN transformer layers whose attention core dispatches to the CUDA
  attention kernels by key length and dropout;
- in training, the feat-proj, hidden, activation and attention dropouts
  (``wav2vec2.py:464-489``, ``:568-577``), drawn from a ``StepRNG``;
- exact-lengths masking from relative ``wav_lens`` and the per-row
  input/output layer norms of the SB bridge (``HuggingFaceWav2Vec2``), or
  in training the whole-batch norms over the real rows (``row_mask``), and
  the bridge's ``freeze`` / ``freeze_feature_extractor``.

"group" extractors, post-LN encoders, data2vec's stacked positional convs,
WavLM's relative position bias, remat and activation sharding are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.activations import fast_gelu
from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d, conv_output_length
from svt_speechbrain_tpu_torch.nnet.dropout import dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (
    LayerNorm, global_layer_norm, per_item_masked_layer_norm)
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf

# the CI-sized architecture of the JAX package (``wav2vec2.py:50``)
TINY_ARCH = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_size=128,
                 conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)
TINY_FEAT_DIM = 64


@dataclasses.dataclass
class Wav2Vec2Config:
    """Architecture hyperparameters; defaults = wav2vec2-large-lv60
    (``wav2vec2.py:57``)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_size: int = 4096
    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    feat_extract_norm: str = "layer"
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.1
    feat_proj_layer_norm: bool = True
    pos_conv_type: str = "weight_norm"
    rel_pos_bias: bool = False
    attention_impl: str = "auto"
    remat_frontend: bool = False
    remat: bool = False
    act_sharding: tuple | None = None

    def output_length(self, num_samples: int) -> int:
        """Frames for ``num_samples`` samples (≈49.8 Hz at 16 kHz)."""
        t = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = conv_output_length(t, k, s)
        return t

    def output_length_tensor(self, num_samples):
        """Per-row frame counts of an int tensor of sample counts: floor
        division, clamped at 0 (``output_length_jnp``, ``wav2vec2.py:167``)."""
        t = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = torch.clamp(torch.div(t - k, s, rounding_mode="floor") + 1,
                            min=0)
        return t


def _check_supported(c: Wav2Vec2Config):
    unsupported = {
        "feat_extract_norm='group'": c.feat_extract_norm != "layer",
        "post-LN (do_stable_layer_norm=False)": not c.do_stable_layer_norm,
        "pos_conv_type='stacked' (data2vec)": c.pos_conv_type != "weight_norm",
        "rel_pos_bias (WavLM)": c.rel_pos_bias,
        "remat": c.remat or c.remat_frontend,
        "act_sharding": c.act_sharding is not None,
        "feat_proj_layer_norm=False": not c.feat_proj_layer_norm,
    }
    missing = [name for name, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"not ported yet: {', '.join(missing)}")


class _ExtractorLayer(nn.Module):
    def __init__(self, conv, layer_norm):
        super().__init__()
        self.conv = conv
        self.layer_norm = layer_norm


class ConvFeatureExtractor(nn.Module):
    """Strided-conv waveform frontend, "layer" norm mode
    (``wav2vec2.py:176``)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        c = config
        self.config = c
        layers, in_ch = [], 1
        for dim, k, s in zip(c.conv_dim, c.conv_kernel, c.conv_stride):
            layers.append(_ExtractorLayer(
                Conv1d(dim, k, in_ch, stride=s, bias=c.conv_bias),
                LayerNorm(dim, eps=c.layer_norm_eps)))
            in_ch = dim
        self.layers = nn.ModuleList(layers)
        self._packed_key = None
        self._packed = None

    def packed(self, dtype):
        """The kernel's packed weights for ``dtype``, packed once and
        repacked only when the weights move or change (or are swapped for
        other tensors, as a cast for bf16 compute does)."""
        sources = [(l.conv.weight, l.conv.bias, l.layer_norm.scale,
                    l.layer_norm.bias) for l in self.layers]
        key = (dtype, tuple((id(t), t.data_ptr(), t._version)
                            for src in sources for t in src if t is not None))
        if key != self._packed_key:
            self._packed = cf.pack_weights(*zip(*sources), dtype)
            self._packed_key = key
        return self._packed

    def forward(self, wav, fused=True):
        """wav (B, T_samples) → (B, T_frames, conv_dim[-1])."""
        if fused and cf.can_fuse(self.config, wav):
            return cf.fused_conv_frontend(wav, self.packed(wav.dtype),
                                          eps=self.config.layer_norm_eps)
        x = wav[..., None]
        for layer in self.layers:
            x = fast_gelu(layer.layer_norm(layer.conv(x)))
        return x


class ConvPositionalEmbedding(nn.Module):
    """Weight-normed grouped conv positional embedding
    (``wav2vec2.py:261``): ``v`` in torch layout (out, in/groups, k),
    ``g`` (1, 1, k); weight-norm over all axes but k, "+1e-12" inside the
    sqrt; pad k//2 each side, trim one frame for even k, GELU."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        c = config
        self.kernel = c.num_conv_pos_embeddings
        self.groups = c.num_conv_pos_embedding_groups
        d = c.hidden_size
        self.v = nn.Parameter(torch.zeros(d, d // self.groups, self.kernel))
        self.g = nn.Parameter(torch.ones(1, 1, self.kernel))
        self.b = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        v = self.v.float()
        norm = torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True) + 1e-12)
        w = (v * (self.g.float() / norm)).to(x.dtype)
        k = self.kernel
        xp = F.pad(x.transpose(1, 2), (k // 2, k // 2))
        y = F.conv1d(xp, w, groups=self.groups).transpose(1, 2)
        y = y + self.b.to(x.dtype)
        if k % 2 == 0:
            y = y[:, :-1]
        return fast_gelu(y)


def _drop(x, rate, rng, train):
    return dropout(x, rate, None if rng is None else rng.device, train)


class TransformerLayer(nn.Module):
    """One pre-LN wav2vec2 encoder layer (``wav2vec2.py:430``): attention
    dropout inside the attention core, hidden dropout after the attention
    and FFN outputs, activation dropout after the GELU."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        c = config
        self.config = c
        self.attn = MultiheadAttention(c.num_heads, c.hidden_size,
                                       dropout=c.attention_dropout)
        self.ffn1 = Linear(c.ffn_size, c.hidden_size)
        self.ffn2 = Linear(c.hidden_size, c.ffn_size)
        self.ln1 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.ln2 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x, key_lengths=None, rng=None, train=False):
        c = self.config
        h = self.ln1(x)
        h = self.attn(h, h, h, key_lengths=key_lengths,
                      impl=c.attention_impl, rng=rng, train=train)
        x = x + _drop(h, c.hidden_dropout, rng, train)
        h = _drop(fast_gelu(self.ffn1(self.ln2(x))), c.activation_dropout,
                  rng, train)
        return x + _drop(self.ffn2(h), c.hidden_dropout, rng, train)


class Wav2Vec2Encoder(nn.Module):
    """wav (B, T_samples) → features (B, T_frames, d) (``wav2vec2.py:501``)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        _check_supported(config)
        c = config
        self.config = c
        self.feature_extractor = ConvFeatureExtractor(c)
        self.feat_proj_ln = LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
        self.feat_proj = Linear(c.hidden_size, c.conv_dim[-1])
        self.pos_conv = ConvPositionalEmbedding(c)
        self.encoder_ln = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(c)
                                    for _ in range(c.num_layers))

    def forward(self, wav, fused_frontend, num_frames=None, rng=None,
                train=False):
        """``fused_frontend`` picks the frontend kernel; the bridge decides
        it. ``num_frames`` (B,) enables exact-lengths masking: junk frames
        are zeroed before ``feat_proj_ln`` and again before the positional
        conv, and attention sees ``key_lengths = num_frames``
        (``wav2vec2.py:552-567``). ``train`` with a ``StepRNG`` turns on
        the dropouts."""
        c = self.config
        x = self.feature_extractor(wav, fused=fused_frontend)
        valid = key_lengths = None
        if num_frames is not None:
            valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < num_frames[:, None])[..., None].to(x.dtype)
            x = x * valid
            key_lengths = num_frames.to(torch.int32)
        x = self.feat_proj(self.feat_proj_ln(x))
        if valid is not None:
            x = x * valid
        x = _drop(x, c.feat_proj_dropout, rng, train)
        x = _drop(x + self.pos_conv(x), c.hidden_dropout, rng, train)
        for layer in self.layers:
            x = layer(x, key_lengths=key_lengths, rng=rng, train=train)
        return self.encoder_ln(x)


class HuggingFaceWav2Vec2(nn.Module):
    """The SB bridge (``wav2vec2.py:619``): optional wav layer-norm,
    encoder, optional output layer-norm.

    Example
    -------
    >>> import torch
    >>> cfg = Wav2Vec2Config(hidden_size=32, num_layers=2, num_heads=4,
    ...                      ffn_size=64, conv_dim=(16,) * 7,
    ...                      num_conv_pos_embeddings=16,
    ...                      num_conv_pos_embedding_groups=4)
    >>> model = HuggingFaceWav2Vec2(config=cfg)
    >>> model(torch.ones(2, 3200)).shape, cfg.output_length(3200)
    (torch.Size([2, 9, 32]), 9)
    """

    def __init__(self, source=None, config: Wav2Vec2Config | None = None,
                 output_norm=True, normalize_wav=True, freeze=False,
                 freeze_feature_extractor=False, arch_overrides=None,
                 save_path=None):
        super().__init__()
        if config is None:
            name = (source or "wav2vec2-large-lv60").lower()
            if "base" in name or any(f in name for f in
                                     ("hubert", "data2vec", "wavlm")):
                raise NotImplementedError(
                    f"only wav2vec2-large-lv60 is ported, not {source!r}")
            config = Wav2Vec2Config()
        if arch_overrides:
            config = dataclasses.replace(
                config, **{k: tuple(v) if isinstance(v, list) else v
                           for k, v in arch_overrides.items()})
        self.config = config
        self.source = source
        self.save_path = save_path
        self.output_norm = output_norm
        # the HF processor's do_normalize: True for lv60 (the "base" models,
        # which set it False, are not ported)
        self.normalize_wav = normalize_wav
        # ``freeze`` runs the whole bridge without gradients or dropout
        # (the reference detaches); ``freeze_feature_extractor`` takes the
        # conv extractor's parameters out of autograd (``wav2vec2.py:715-722``)
        self.freeze = freeze
        self.freeze_feature_extractor = freeze_feature_extractor
        self.encoder = Wav2Vec2Encoder(config)
        if freeze_feature_extractor:
            self.encoder.feature_extractor.requires_grad_(False)

    def load_pretrained(self):
        """The bridge's state dict converted from a local HF checkpoint at
        ``save_path`` (or at ``source`` when that is a path), or None when
        there is none (``wav2vec2.py:684``); nothing is downloaded."""
        from svt_speechbrain_tpu_torch.models.convert_hf import load_wav2vec2

        for candidate in (self.save_path, self.source):
            if candidate and os.path.exists(candidate):
                encoder, _ = load_wav2vec2(candidate, self.config)
                return {f"encoder.{k}": v
                        for k, v in encoder.state_dict().items()}
        return None

    def forward(self, wav, wav_lens=None, rng=None, train=False,
                row_mask=None):
        """Without ``wav_lens`` the input and output norms run over the
        whole batch (the bridge's ``F.layer_norm(x, x.shape)``), over the
        rows where ``row_mask`` (B,) is 1 if it is given. With ``wav_lens``
        (relative, (B,)) they run per row over its real content only and
        padded frames are masked through the encoder; rows of length 0 are
        batch padding. ``train`` with a ``StepRNG`` turns on dropout."""
        if self.freeze:
            with torch.no_grad():
                return self._forward(wav, wav_lens, None, False, row_mask)
        return self._forward(wav, wav_lens, rng, train, row_mask)

    def _forward(self, wav, wav_lens, rng, train, row_mask):
        num_frames = sample_valid = None
        if wav_lens is not None:
            t = wav.shape[1]
            true_samples = torch.round(
                wav_lens.to(wav.device, torch.float32) * t).to(torch.int32)
            num_frames = self.config.output_length_tensor(true_samples)
            sample_valid = (torch.arange(t, device=wav.device)[None, :]
                            < true_samples[:, None])
        if self.normalize_wav:
            if wav_lens is None:
                wav = global_layer_norm(wav, row_mask=row_mask)
            else:
                wav = per_item_masked_layer_norm(wav, sample_valid)
                wav = wav * sample_valid.to(wav.dtype)
        # a frozen extractor takes no gradient, so the fused frontend
        # kernel serves training steps too (``wav2vec2.py:741-742``)
        out = self.encoder(
            wav, (not train) or self.freeze_feature_extractor,
            num_frames=num_frames, rng=rng, train=train)
        if self.output_norm:
            if wav_lens is None:
                out = global_layer_norm(out, row_mask=row_mask)
            else:
                frame_valid = (torch.arange(out.shape[1], device=out.device)
                               [None, :] < num_frames[:, None])
                out = per_item_masked_layer_norm(out, frame_valid)
        return out

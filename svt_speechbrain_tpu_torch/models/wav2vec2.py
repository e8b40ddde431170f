"""wav2vec 2.0 encoder family (port of ``svt_speechbrain_tpu/models/wav2vec2.py``).

Every architecture the JAX ``Wav2Vec2Config`` expresses, for serving and
training: wav2vec2 base and large-lv60, HuBERT, data2vec-audio and WavLM,
base and large (``Wav2Vec2Config.base()`` ... ``wavlm_large()``, or by name
through the bridge, as the reference bridge picks them):

- the conv extractor (``ConvFeatureExtractor``) in "layer" mode (a
  LayerNorm after every conv), dispatched to the CUDA conv-frontend kernel
  when ``ops.conv_frontend.can_fuse`` holds and the frontend is fused (not
  training, or a frozen extractor; the bridge's ``fused_frontend=False``
  selects the plain convolutions, for f64), with or without conv biases;
  or in
  "group" mode (a per-channel GroupNorm after the first conv only), which
  runs the plain convolutions and, given ``true_samples``, takes the group
  statistics over each row's valid frames only;
- feature projection (LayerNorm, unless ``feat_proj_layer_norm=False`` →
  Linear);
- the weight-normed grouped positional conv (k=128, groups=16) + GELU, or
  data2vec's stack of plain grouped convs, each followed by a non-affine
  LayerNorm and GELU;
- pre-LN ("stable layer norm") or post-LN transformer layers. The attention
  core of the standard families dispatches to the CUDA attention kernels by
  key length and dropout; WavLM's gated relative position bias attention
  (``WavLMSelfAttention``) runs eagerly, as in the JAX package, since the
  kernels take no bias;
- in training, the feat-proj, hidden, activation and attention dropouts
  (``wav2vec2.py:464-489``, ``:568-577``), drawn from a ``StepRNG``;
  ``remat`` recomputes each layer and ``remat_frontend`` the extractor in
  the backward pass (``torch.utils.checkpoint``), the recomputation
  replaying the dropout draws of the first pass (``_replaying``);
- exact-lengths masking from relative ``wav_lens`` and the per-row
  input/output layer norms of the SB bridge (``HuggingFaceWav2Vec2``), or
  in training the whole-batch norms over the real rows (``row_mask``), and
  the bridge's ``freeze`` / ``freeze_feature_extractor``.

``act_sharding`` (a mesh axis name, or None, per activation axis) runs the
layers sequence-parallel over the mesh axis it names for the frames, on the
active mesh (``parallel.mesh.use_mesh``), where the JAX layer constrains
its output's sharding: each rank holds its slice of the frames between
layers and runs the norms, the feed-forward block and the residuals on it,
and the attention gathers the whole sequence (``parallel.mesh.
SequenceShards``). The numbers are those of the unsharded run; without an
active mesh it raises, as ``with_sharding_constraint`` does.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from svt_speechbrain_tpu_torch.nnet.activations import fast_gelu
from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d, conv_output_length
from svt_speechbrain_tpu_torch.nnet.dropout import dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (
    GroupNorm, LayerNorm, global_layer_norm, layer_norm,
    per_item_masked_layer_norm, wide)
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf

# the CI-sized architecture of the JAX package (``wav2vec2.py:50``)
TINY_ARCH = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_size=128,
                 conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)
TINY_FEAT_DIM = 64


@dataclasses.dataclass
class Wav2Vec2Config:
    """Architecture hyperparameters; defaults = wav2vec2-large-lv60
    (``wav2vec2.py:57``). ``pos_conv_type`` "weight_norm" is the single
    weight-normed positional conv, "stacked" data2vec's ``pos_conv_depth``
    plain convs of kernel ``pos_conv_kernel``; ``rel_pos_bias`` is WavLM's
    gated relative position bias over ``num_buckets`` buckets."""

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
    pos_conv_depth: int = 5
    pos_conv_kernel: int = 19
    rel_pos_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800
    attention_impl: str = "auto"
    remat_frontend: bool = False
    remat: bool = False
    act_sharding: tuple | None = None

    @classmethod
    def base(cls):
        return cls(hidden_size=768, num_layers=12, num_heads=12,
                   ffn_size=3072, feat_extract_norm="group", conv_bias=False,
                   do_stable_layer_norm=False)

    @classmethod
    def large_lv60(cls):
        return cls()

    @classmethod
    def hubert_base(cls):
        """``hubert-base-ls960`` (the wav2vec2-base encoder)."""
        return cls.base()

    @classmethod
    def hubert_large(cls):
        """``hubert-large-ll60k`` (the wav2vec2-large-lv60 encoder)."""
        return cls()

    @classmethod
    def data2vec_audio_base(cls):
        """``data2vec-audio-base``: "layer" extractor without conv bias, 5
        stacked positional convs (k=19), post-LN."""
        return cls(hidden_size=768, num_layers=12, num_heads=12,
                   ffn_size=3072, feat_extract_norm="layer", conv_bias=False,
                   do_stable_layer_norm=False, pos_conv_type="stacked")

    @classmethod
    def data2vec_audio_large(cls):
        return cls(feat_extract_norm="layer", conv_bias=False,
                   do_stable_layer_norm=False, pos_conv_type="stacked")

    @classmethod
    def wavlm_base(cls):
        """``wavlm-base(-plus)``: the wav2vec2-base encoder with the gated
        relative position bias."""
        return cls(hidden_size=768, num_layers=12, num_heads=12,
                   ffn_size=3072, feat_extract_norm="group", conv_bias=False,
                   do_stable_layer_norm=False, rel_pos_bias=True)

    @classmethod
    def wavlm_large(cls):
        return cls(conv_bias=False, rel_pos_bias=True)

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


def config_for_name(name):
    """The family a checkpoint name picks, as the reference bridge sniffs
    it (``wav2vec2.py:646-663``): HuBERT, data2vec or WavLM by substring,
    else wav2vec2; base if "base" is in the name, else large."""
    name = (name or "wav2vec2-large-lv60").lower()
    size = "base" if "base" in name else "large"
    for family, make in (("hubert", "hubert_"), ("data2vec", "data2vec_audio_"),
                         ("wavlm", "wavlm_")):
        if family in name:
            return getattr(Wav2Vec2Config, make + size)()
    return (Wav2Vec2Config.base() if size == "base"
            else Wav2Vec2Config.large_lv60())


def normalizes_wav(name):
    """The HF processor's ``do_normalize`` for a checkpoint name
    (``wav2vec2.py:672-676``): False for a name ending in "base" or holding
    "base-960h", True otherwise."""
    name = (name or "").lower()
    return not name.endswith("base") and "base-960h" not in name


def _check_supported(c: Wav2Vec2Config):
    """Every field of the JAX config has a port; an ``act_sharding`` needs
    one name (or None) per (B, T, D) axis."""
    if c.act_sharding is not None and len(c.act_sharding) != 3:
        raise ValueError(f"act_sharding names the (B, T, D) axes, not "
                         f"{c.act_sharding!r}")


class _ExtractorLayer(nn.Module):
    """One conv of the extractor with its norm: ``layer_norm`` in "layer"
    mode, ``group_norm`` on the first conv in "group" mode, else none."""

    def __init__(self, conv, layer_norm=None, group_norm=None):
        super().__init__()
        self.conv = conv
        self.layer_norm = layer_norm
        self.group_norm = group_norm


def _masked_group_norm(gn, x, t_valid):
    """``gn`` on (B, T, C) with per-(row, group) statistics over each row's
    first ``t_valid`` frames only; the other frames come out as zeros
    (``wav2vec2.py:244``), which the GELU after it keeps."""
    b, t, ch = x.shape
    g = gn.num_groups
    valid = (torch.arange(t, device=x.device)[None, :]
             < t_valid.to(x.device)[:, None])                    # (B, T)
    x32 = wide(x).reshape(b, t, g, ch // g)
    m = valid[:, :, None, None].to(x32.dtype)
    count = torch.clamp(m.sum(dim=(1, 3), keepdim=True) * (ch // g), min=1.0)
    mean = (x32 * m).sum(dim=(1, 3), keepdim=True) / count
    var = ((x32 - mean).square() * m).sum(dim=(1, 3), keepdim=True) / count
    y = ((x32 - mean) * torch.rsqrt(var + gn.eps)).reshape(b, t, ch)
    y = y * gn.scale + gn.bias
    return (y * valid[..., None]).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """Strided-conv waveform frontend, "layer" or "group" norm mode
    (``wav2vec2.py:176``)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        c = config
        self.config = c
        layers, in_ch = [], 1
        for i, (dim, k, s) in enumerate(zip(c.conv_dim, c.conv_kernel,
                                            c.conv_stride)):
            conv = Conv1d(dim, k, in_ch, stride=s, padding="valid",
                          bias=c.conv_bias)
            if c.feat_extract_norm == "layer":
                layers.append(_ExtractorLayer(
                    conv, layer_norm=LayerNorm(dim, eps=c.layer_norm_eps)))
            elif i == 0:
                layers.append(_ExtractorLayer(conv, group_norm=GroupNorm(
                    dim, num_groups=dim, eps=c.layer_norm_eps)))
            else:
                layers.append(_ExtractorLayer(conv))
            in_ch = dim
        self.layers = nn.ModuleList(layers)
        self._packed_key = None
        self._packed = None

    def packed(self, dtype):
        """The kernel's packed weights for ``dtype`` ("layer" mode), packed
        once and repacked only when the weights move or change (or are
        swapped for other tensors, as a cast for bf16 compute does)."""
        sources = [(l.conv.weight, l.conv.bias, l.layer_norm.scale,
                    l.layer_norm.bias) for l in self.layers]
        key = (dtype, tuple((id(t), t.data_ptr(), t._version)
                            for src in sources for t in src if t is not None))
        if key != self._packed_key:
            self._packed = cf.pack_weights(*zip(*sources), dtype)
            self._packed_key = key
        return self._packed

    def forward(self, wav, fused=True, true_samples=None):
        """wav (B, T_samples) → (B, T_frames, conv_dim[-1]). With
        ``true_samples`` (B,) the "group" mode's statistics run over each
        row's valid frames only; the "layer" mode's per-frame norms need no
        lengths."""
        c = self.config
        if fused and cf.can_fuse(c, wav):
            return cf.fused_conv_frontend(wav, self.packed(wav.dtype),
                                          eps=c.layer_norm_eps)
        x = wav[..., None]
        t_valid = true_samples
        for layer, k, s in zip(self.layers, c.conv_kernel, c.conv_stride):
            x = layer.conv(x)
            if t_valid is not None:
                t_valid = torch.clamp(
                    torch.div(t_valid - k, s, rounding_mode="floor") + 1,
                    min=0)
            if layer.layer_norm is not None:
                x = layer.layer_norm(x)
            elif layer.group_norm is not None:
                x = (layer.group_norm(x) if t_valid is None
                     else _masked_group_norm(layer.group_norm, x, t_valid))
            x = fast_gelu(x)
        # the convs hand back channel-last views of channel-first outputs,
        # and the int8 kernel behind feat_proj takes contiguous rows only
        return x.contiguous()


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
        v = wide(self.v)
        norm = torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True) + 1e-12)
        w = (v * (self.g.to(v.dtype) / norm)).to(x.dtype)
        return fast_gelu(_same_conv(x, w, self.b, self.groups))


def _same_conv(x, w, b, groups):
    """Grouped conv of (B, T, C) with ``w`` (out, in/groups, k): pad k//2
    on each side, trim the last frame for even k (HF
    ``Wav2Vec2SamePadLayer``), add ``b``."""
    k = w.shape[-1]
    xp = F.pad(x.transpose(1, 2), (k // 2, k // 2))
    y = F.conv1d(xp, w.to(x.dtype), groups=groups).transpose(1, 2)
    y = y + b.to(x.dtype)
    return y[:, :-1] if k % 2 == 0 else y


class _PosConv(nn.Module):
    """One plain grouped conv of the stacked positional embedding: ``w``
    (out, in/groups, k), ``b`` (out,)."""

    def __init__(self, d, k, groups):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d, d // groups, k))
        self.b = nn.Parameter(torch.zeros(d))


class StackedPositionalConvEmbedding(nn.Module):
    """data2vec-audio's positional embedding (``wav2vec2.py:302``):
    ``pos_conv_depth`` blocks ``"0"``, ``"1"``, ... of [grouped conv (same
    padding, right trim for even k) → non-affine LayerNorm → GELU]; plain
    convs, no weight norm."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        c = config
        self.groups = c.num_conv_pos_embedding_groups
        self.depth = c.pos_conv_depth
        for i in range(c.pos_conv_depth):
            self.add_module(str(i), _PosConv(c.hidden_size, c.pos_conv_kernel,
                                             self.groups))

    def forward(self, x):
        for i in range(self.depth):
            conv = getattr(self, str(i))
            x = fast_gelu(layer_norm(_same_conv(x, conv.w, conv.b,
                                                self.groups)))
        return x


def _wavlm_relative_position_buckets(t, num_buckets, max_distance):
    """T5-style bidirectional log-bucketed relative positions (HF
    ``WavLMAttention._relative_positions_bucket``), (T, T) int64, with the
    JAX package's numpy arithmetic (``wav2vec2.py:341``): float64 log and
    int64 casts, so that the bucket edges fall where they fall there."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]  # memory - context
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


@functools.lru_cache(maxsize=4)
def _bucket_index(t, num_buckets, max_distance):
    """The bucket table as a CPU tensor, built once a frame count (a 30 s
    window's is 1499² entries)."""
    return torch.from_numpy(_wavlm_relative_position_buckets(
        t, num_buckets, max_distance))


class WavLMSelfAttention(nn.Module):
    """WavLM's gated relative-position-bias self-attention
    (``wav2vec2.py:359``): QKV attention plus a bucketed relative position
    bias (the embedding ``rel_attn_embed`` (buckets, H) is owned by layer 0
    and shared by every layer), scaled per (batch, head, query) by a gate
    computed from the layer's input: ``gru_w`` (head_dim, 8), ``gru_b``
    (8,), ``gru_const`` (1, H, 1, 1). Padded keys are filled with the f32
    minimum through ``key_padding_mask``. The scores and softmax run eagerly
    in f32, with attention dropout on the weights in training."""

    def __init__(self, num_heads, hidden_size, has_rel_attn_embed=False,
                 num_buckets=320, max_distance=800, dropout=0.0):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        self.hidden_size = d
        self.head_dim = d // num_heads
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.dropout = dropout
        for name in ("q", "k", "v", "o"):
            setattr(self, f"w{name}", nn.Parameter(torch.zeros(d, d)))
            setattr(self, f"b{name}", nn.Parameter(torch.zeros(d)))
        self.gru_w = nn.Parameter(torch.zeros(self.head_dim, 8))
        self.gru_b = nn.Parameter(torch.zeros(8))
        self.gru_const = nn.Parameter(torch.ones(1, num_heads, 1, 1))
        self.rel_attn_embed = (
            nn.Parameter(torch.zeros(num_buckets, num_heads))
            if has_rel_attn_embed else None)

    def compute_bias(self, t):
        """(H, T, T) relative position bias from this layer's embedding."""
        buckets = _bucket_index(t, self.num_buckets, self.max_distance).to(
            self.rel_attn_embed.device)
        return self.rel_attn_embed[buckets].permute(2, 0, 1)

    def forward(self, x, position_bias, key_padding_mask=None, rng=None,
                train=False):
        b, t, d = x.shape
        h, hd = self.num_heads, self.head_dim
        x32 = x.float()
        gated = x32.reshape(b, t, h, hd).transpose(1, 2)          # (B, H, T, hd)
        proj = (gated @ self.gru_w.float() + self.gru_b.float())
        gate = torch.sigmoid(proj.reshape(b, h, t, 2, 4).sum(-1))
        gate_a, gate_b = gate[..., 0:1], gate[..., 1:2]            # (B, H, T, 1)
        gate_out = gate_a * (gate_b * self.gru_const.float() - 1.0) + 2.0

        def proj_heads(name):
            w, bias = getattr(self, "w" + name), getattr(self, "b" + name)
            return (x32 @ w.float() + bias.float()).reshape(b, t, h, hd)

        q, k, v = proj_heads("q"), proj_heads("k"), proj_heads("v")
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(np.sqrt(hd))
        scores = scores + gate_out * position_bias.float()[None]
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1)
        if rng is not None:
            attn = dropout(attn, self.dropout, rng.device, train)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d)
        out = out @ self.wo.float() + self.bo.float()
        return out.to(x.dtype)


def run_layers(layers, c, x, position_bias, kwargs):
    """The transformer layers over ``x``, each recomputed in the backward
    pass under ``remat``; under ``act_sharding`` sequence-parallel on the
    active mesh (``wav2vec2.py:492-497``): ``x`` is cut into each rank's
    slice of the frames before the first layer and gathered whole after the
    last, and the layers' parameters and the shared position bias, used on
    the slices, sum their gradients over the ranks."""
    rng = kwargs.get("rng")
    seq = None
    if c.act_sharding is not None:
        from svt_speechbrain_tpu_torch.parallel.mesh import sequence_shards

        seq = sequence_shards(c.act_sharding, x.shape[1])
    if seq is None:
        for layer in layers:
            x = (_remat(layer, rng, (x, position_bias), kwargs) if c.remat
                 else layer(x, position_bias, **kwargs))
        return x
    x = seq.scatter(x)
    if position_bias is not None:
        position_bias = seq.summed(position_bias)
    kwargs = dict(kwargs, seq=seq)
    for layer in layers:
        tensors = {**{n: seq.summed(p) for n, p in layer.named_parameters()},
                   **dict(layer.named_buffers())}
        x = (_remat(layer, rng, (x, position_bias), kwargs, tensors)
             if c.remat else torch.func.functional_call(
                 layer, tensors, (x, position_bias), kwargs))
    return seq.gather(x, partial=False)


def _drop(x, rate, rng, train):
    return dropout(x, rate, None if rng is None else rng.device, train)


class TransformerLayer(nn.Module):
    """One wav2vec2 encoder layer, pre- or post-LN per config
    (``wav2vec2.py:430``): attention dropout inside the attention core,
    hidden dropout after the attention and FFN outputs, activation dropout
    after the GELU. WavLM layers (``rel_pos_bias``) take the shared
    ``position_bias`` and a ``key_padding_mask``; the others take
    ``key_lengths``, which keeps the attention kernels available. With
    ``seq`` (``parallel.mesh.SequenceShards``) ``x`` is the rank's slice of
    the frames: the attention runs on the whole sequence, gathered, and
    keeps the slice of its output; the rest runs on the slice."""

    def __init__(self, config: Wav2Vec2Config, layer_index=0):
        super().__init__()
        c = config
        self.config = c
        if c.rel_pos_bias:
            self.attn = WavLMSelfAttention(
                c.num_heads, c.hidden_size,
                has_rel_attn_embed=(layer_index == 0),
                num_buckets=c.num_buckets, max_distance=c.max_bucket_distance,
                dropout=c.attention_dropout)
        else:
            self.attn = MultiheadAttention(c.num_heads, c.hidden_size,
                                           dropout=c.attention_dropout)
        self.ffn1 = Linear(c.ffn_size, c.hidden_size)
        self.ffn2 = Linear(c.hidden_size, c.ffn_size)
        self.ln1 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.ln2 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x, position_bias=None, key_lengths=None, rng=None,
                train=False, key_padding_mask=None, seq=None):
        c = self.config
        drop = _drop if seq is None else seq.drop

        def attn_block(h):
            if seq is not None:
                h = seq.gather(h)
            if c.rel_pos_bias:
                h = self.attn(h, position_bias,
                              key_padding_mask=key_padding_mask, rng=rng,
                              train=train)
            else:
                h = self.attn(h, h, h, key_lengths=key_lengths,
                              impl=c.attention_impl, rng=rng, train=train)
            h = _drop(h, c.hidden_dropout, rng, train)
            return h if seq is None else seq.local(h)

        def ffn_block(h):
            h = drop(fast_gelu(self.ffn1(h)), c.activation_dropout, rng,
                     train)
            return drop(self.ffn2(h), c.hidden_dropout, rng, train)

        if c.do_stable_layer_norm:                      # pre-LN
            x = x + attn_block(self.ln1(x))
            return x + ffn_block(self.ln2(x))
        x = self.ln1(x + attn_block(x))                 # post-LN
        return self.ln2(x + ffn_block(x))


def _replaying(fn, rng):
    """``fn`` for ``torch.utils.checkpoint``: its recomputation in the
    backward pass draws the dropout masks and attention seeds that its
    first call drew. The step's generators are explicit
    ``torch.Generator``s, which checkpoint's ``preserve_rng_state`` does
    not save, so their states are taken before the first call (as the JAX
    package splits a layer's keys before ``jax.checkpoint``), set for the
    recomputation and put back after it."""
    if rng is None:
        return fn
    gens = (rng.device, rng.host)
    before = [g.get_state() for g in gens]
    calls = []

    def run(*args):
        calls.append(None)
        if len(calls) == 1:
            return fn(*args)
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, before):
            g.set_state(state)
        try:
            return fn(*args)
        finally:
            for g, state in zip(gens, after):
                g.set_state(state)

    return run


def _remat(module, rng, args, kwargs, tensors=None):
    """``module(*args, **kwargs)`` with its activations recomputed in the
    backward pass instead of kept (``torch.utils.checkpoint``). The
    recomputation runs on the very parameter tensors of the first pass
    (under ``torch.func.functional_call``, as a training step runs, the
    module's attributes are put back before the backward pass), and replays
    the step's generators (``_replaying``); the port draws from no global
    generator, so checkpoint saves none. ``tensors``, when given, are
    the parameters and buffers to run on instead of the module's."""
    if not torch.is_grad_enabled():
        return (module(*args, **kwargs) if tensors is None else
                torch.func.functional_call(module, tensors, args, kwargs))
    if tensors is None:
        tensors = {**dict(module.named_parameters()),
                   **dict(module.named_buffers())}

    def run(*args):
        return torch.func.functional_call(module, tensors, args, kwargs)

    return checkpoint(_replaying(run, rng), *args, use_reentrant=False,
                      preserve_rng_state=False)


class Wav2Vec2Encoder(nn.Module):
    """wav (B, T_samples) → features (B, T_frames, d) (``wav2vec2.py:501``)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        _check_supported(config)
        c = config
        self.config = c
        self.feature_extractor = ConvFeatureExtractor(c)
        self.feat_proj_ln = (LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
                             if c.feat_proj_layer_norm else None)
        self.feat_proj = Linear(c.hidden_size, c.conv_dim[-1])
        self.pos_conv = (StackedPositionalConvEmbedding(c)
                         if c.pos_conv_type == "stacked"
                         else ConvPositionalEmbedding(c))
        self.encoder_ln = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(c, layer_index=i)
                                    for i in range(c.num_layers))

    def forward(self, wav, fused_frontend, num_frames=None, rng=None,
                train=False, true_samples=None):
        """``fused_frontend`` picks the frontend kernel; the bridge decides
        it. ``num_frames`` (B,) enables exact-lengths masking: junk frames
        are zeroed before the feature projection and again before the
        positional conv, and attention sees ``key_lengths = num_frames``
        (WavLM: the matching ``key_padding_mask``) (``wav2vec2.py:552-567``);
        ``true_samples`` (B,) masks the "group" extractor's statistics.
        ``train`` with a ``StepRNG`` turns on the dropouts."""
        c = self.config
        frontend = dict(fused=fused_frontend, true_samples=true_samples)
        x = (_remat(self.feature_extractor, None, (wav,), frontend)
             if c.remat_frontend else self.feature_extractor(wav, **frontend))
        valid = key_lengths = key_padding_mask = None
        if num_frames is not None:
            frame_valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                           < num_frames[:, None])
            valid = frame_valid[..., None].to(x.dtype)
            x = x * valid
            key_lengths = num_frames.to(torch.int32)
            key_padding_mask = ~frame_valid
        if self.feat_proj_ln is not None:
            x = self.feat_proj_ln(x)
        x = self.feat_proj(x)
        if valid is not None:
            x = x * valid
        x = _drop(x, c.feat_proj_dropout, rng, train)
        x = x + self.pos_conv(x)
        if not c.do_stable_layer_norm:
            x = self.encoder_ln(x)
        x = _drop(x, c.hidden_dropout, rng, train)
        position_bias = (self.layers[0].attn.compute_bias(x.shape[1])
                         if c.rel_pos_bias else None)
        kwargs = dict(key_lengths=key_lengths, rng=rng, train=train,
                      key_padding_mask=key_padding_mask)
        x = run_layers(self.layers, c, x, position_bias, kwargs)
        if c.do_stable_layer_norm:
            x = self.encoder_ln(x)
        return x


class HuggingFaceWav2Vec2(nn.Module):
    """The SB bridge (``wav2vec2.py:619``): optional wav layer-norm,
    encoder, optional output layer-norm. Without ``config`` the family comes
    from the ``source`` name (``config_for_name``); without
    ``normalize_wav`` the wav norm is the HF processor's default for that
    name (``normalizes_wav``). ``fused_frontend=False`` runs the conv
    extractor's plain convolutions where it would launch the frontend
    kernel (which takes f32 and bf16; f64 takes the plain ones).

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
    >>> base = HuggingFaceWav2Vec2("facebook/wav2vec2-base", arch_overrides=
    ...                            dict(num_layers=1))
    >>> base.config.feat_extract_norm, base.normalize_wav
    ('group', False)
    """

    def __init__(self, source=None, config: Wav2Vec2Config | None = None,
                 output_norm=True, normalize_wav=None, freeze=False,
                 freeze_feature_extractor=False, arch_overrides=None,
                 save_path=None, fused_frontend=True):
        super().__init__()
        if isinstance(source, Wav2Vec2Config):       # a positional config
            config, source = source, None
        if config is None:
            config = config_for_name(source)
        if arch_overrides:
            config = dataclasses.replace(
                config, **{k: tuple(v) if isinstance(v, list) else v
                           for k, v in arch_overrides.items()})
        self.config = config
        self.source = source
        self.save_path = save_path
        self.output_norm = output_norm
        self.normalize_wav = (normalizes_wav(source) if normalize_wav is None
                              else normalize_wav)
        # ``freeze`` runs the whole bridge without gradients or dropout
        # (the reference detaches); ``freeze_feature_extractor`` takes the
        # conv extractor's parameters out of autograd (``wav2vec2.py:715-722``)
        self.freeze = freeze
        self.freeze_feature_extractor = freeze_feature_extractor
        self.fused_frontend = fused_frontend
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
        num_frames = sample_valid = true_samples = None
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
            wav, self.fused_frontend and ((not train)
                                          or self.freeze_feature_extractor),
            num_frames=num_frames, rng=rng, train=train,
            true_samples=true_samples)
        if self.output_norm:
            if wav_lens is None:
                out = global_layer_norm(out, row_mask=row_mask)
            else:
                frame_valid = (torch.arange(out.shape[1], device=out.device)
                               [None, :] < num_frames[:, None])
                out = per_item_masked_layer_norm(out, frame_valid)
        return out


class Wav2Vec2CTCEncoder(nn.Module):
    """Waveforms → per-frame CTC log-posteriors: the bridge, the
    ``ctc_lin`` head and a log-softmax — the ``encoder`` of SpeechBrain's
    wav2vec2 ``EncoderASR`` models (their yaml's ``LengthsCapableSequential``
    of ``wav2vec2``, ``enc``, ``ctc_lin`` and ``log_softmax``) without the
    ``enc`` DNN between bridge and head. Here the relative
    ``lengths`` reach the bridge as its ``wav_lens``, so that each row is
    normalized over its own samples and its padded frames are masked (the
    batch-1 result, whatever the batch).

    Example
    -------
    >>> import torch
    >>> cfg = Wav2Vec2Config(hidden_size=32, num_layers=1, num_heads=4,
    ...                      ffn_size=64, conv_dim=(16,) * 7,
    ...                      num_conv_pos_embeddings=16,
    ...                      num_conv_pos_embedding_groups=4)
    >>> enc = Wav2Vec2CTCEncoder(HuggingFaceWav2Vec2(config=cfg),
    ...                          Linear(5, 32))
    >>> lp = enc(torch.ones(2, 3200), lengths=torch.tensor([1.0, 0.5]))
    >>> lp.shape, bool(lp.exp().sum(-1).sub(1).abs().max() < 1e-5)
    (torch.Size([2, 9, 5]), True)
    """

    def __init__(self, wav2vec2, ctc_lin):
        super().__init__()
        self.wav2vec2 = wav2vec2
        self.ctc_lin = ctc_lin

    def forward(self, wavs, lengths=None):
        feats = self.wav2vec2(wavs, wav_lens=lengths)
        return torch.log_softmax(self.ctc_lin(feats), dim=-1)

"""Fill the port's wav2vec2 encoder from a HuggingFace-layout checkpoint
(port of ``svt_speechbrain_tpu/models/convert_hf.py``).

Conversion is an explicit offline step: read a local checkpoint
(safetensors preferred, ``pytorch_model.bin`` otherwise) and map its names
onto ``models.wav2vec2.Wav2Vec2Encoder``'s. Layout changes:

- ``nn.Linear`` (out, in) → the port's ``w`` (in, out) [transpose];
- ``nn.Conv1d`` weights keep torch's (out, in/groups, k);
- the weight-normed positional conv's ``weight_g`` (1, 1, k) → ``g`` and
  ``weight_v`` → ``v``, under both the classic names and the
  ``parametrizations.weight.original0/1`` ones.

Every family of the name-sniffing bridge converts (``convert_hf.py:50``):
``Wav2Vec2Model`` base and large, ``HubertModel`` (with or without the
projection LayerNorm), ``Data2VecAudioModel`` (stacked plain positional
convs, no conv bias) and ``WavLMModel`` (gated relative position bias).
The "group" extractor's GroupNorm is stored as ``conv_layers.0.layer_norm``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from svt_speechbrain_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                       Wav2Vec2Encoder,
                                                       _check_supported)

_PREFIXES = ("wav2vec2.", "hubert.", "data2vec_audio.", "wavlm.")
_NORM = {"weight": "scale", "bias": "bias"}


def load_state_dict(path):
    """A flat name → tensor dict from a HF checkpoint directory or file."""
    if os.path.isdir(path):
        for candidate in ("model.safetensors", "pytorch_model.bin"):
            f = os.path.join(path, candidate)
            if os.path.exists(f):
                path = f
                break
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def convert_wav2vec2_state_dict(sd, config):
    """HF state dict (tensors or numpy arrays) → the state dict of a
    ``Wav2Vec2Encoder(config)``, every entry a contiguous f32 tensor.
    Entries the encoder does not use (``masked_spec_embed``, pretraining
    heads) are left out; a missing one raises ``KeyError``.

    Example
    -------
    >>> import torch
    >>> cfg = Wav2Vec2Config(hidden_size=32, num_layers=1, num_heads=4,
    ...                      ffn_size=64, conv_dim=(16,) * 7,
    ...                      num_conv_pos_embeddings=16,
    ...                      num_conv_pos_embedding_groups=4)
    >>> enc = Wav2Vec2Encoder(cfg)
    >>> hf = {"feature_projection.projection.weight": torch.ones(32, 16)}
    >>> convert_wav2vec2_state_dict(hf, cfg)
    Traceback (most recent call last):
        ...
    KeyError: 'feature_extractor.conv_layers.0.conv.weight'
    """
    _check_supported(config)
    for prefix in _PREFIXES:
        sd = {k.removeprefix(prefix): v for k, v in sd.items()}
    def get(key, transpose=False):
        t = torch.as_tensor(np.asarray(sd[key]), dtype=torch.float32)
        return (t.t() if transpose else t).contiguous().clone()

    out = {}

    def norm(dst, src):
        for hf_leaf, leaf in _NORM.items():
            out[f"{dst}.{leaf}"] = get(f"{src}.{hf_leaf}")

    def linear(dst, src):
        out[f"{dst}.w"] = get(f"{src}.weight", transpose=True)
        out[f"{dst}.b"] = get(f"{src}.bias")

    for i in range(len(config.conv_dim)):
        src, dst = (f"feature_extractor.conv_layers.{i}",
                    f"feature_extractor.layers.{i}")
        out[f"{dst}.conv.weight"] = get(f"{src}.conv.weight")
        if config.conv_bias:
            out[f"{dst}.conv.bias"] = get(f"{src}.conv.bias")
        if config.feat_extract_norm == "layer":
            norm(f"{dst}.layer_norm", f"{src}.layer_norm")
        elif i == 0:
            norm(f"{dst}.group_norm", f"{src}.layer_norm")
    if config.feat_proj_layer_norm:
        norm("feat_proj_ln", "feature_projection.layer_norm")
    linear("feat_proj", "feature_projection.projection")

    if config.pos_conv_type == "stacked":
        for i in range(config.pos_conv_depth):
            pc = f"encoder.pos_conv_embed.layers.{i}.conv."
            out[f"pos_conv.{i}.w"] = get(pc + "weight")
            out[f"pos_conv.{i}.b"] = get(pc + "bias")
    else:
        pc = "encoder.pos_conv_embed.conv."
        if pc + "weight_g" in sd:
            g, v = pc + "weight_g", pc + "weight_v"
        else:
            g = pc + "parametrizations.weight.original0"
            v = pc + "parametrizations.weight.original1"
        out["pos_conv.g"], out["pos_conv.v"] = get(g), get(v)
        out["pos_conv.b"] = get(pc + "bias")
    norm("encoder_ln", "encoder.layer_norm")

    for i in range(config.num_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        for name in ("q", "k", "v"):
            out[f"{dst}.attn.w{name}"] = get(
                f"{src}.attention.{name}_proj.weight", transpose=True)
            out[f"{dst}.attn.b{name}"] = get(
                f"{src}.attention.{name}_proj.bias")
        out[f"{dst}.attn.wo"] = get(f"{src}.attention.out_proj.weight",
                                    transpose=True)
        out[f"{dst}.attn.bo"] = get(f"{src}.attention.out_proj.bias")
        if config.rel_pos_bias:
            att = f"{src}.attention."
            out[f"{dst}.attn.gru_const"] = get(att + "gru_rel_pos_const")
            out[f"{dst}.attn.gru_w"] = get(
                att + "gru_rel_pos_linear.weight", transpose=True)
            out[f"{dst}.attn.gru_b"] = get(att + "gru_rel_pos_linear.bias")
            if i == 0:
                out[f"{dst}.attn.rel_attn_embed"] = get(
                    att + "rel_attn_embed.weight")
        norm(f"{dst}.ln1", f"{src}.layer_norm")
        norm(f"{dst}.ln2", f"{src}.final_layer_norm")
        linear(f"{dst}.ffn1", f"{src}.feed_forward.intermediate_dense")
        linear(f"{dst}.ffn2", f"{src}.feed_forward.output_dense")
    return out


def config_from_hf(hf):
    """The port's ``Wav2Vec2Config`` for a HF ``config.json`` dict of any
    family (``convert_hf.py:202-229``): a data2vec-audio config without
    ``feat_extract_norm`` is "layer" (others default to "group"), its depth
    of stacked positional convs is ``num_conv_pos_embeddings`` and their
    kernel ``conv_pos_kernel_size``; WavLM takes its bucket settings."""
    model_type = hf.get("model_type", "wav2vec2")
    data2vec = model_type == "data2vec-audio"
    return Wav2Vec2Config(
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        ffn_size=hf["intermediate_size"],
        conv_dim=tuple(hf["conv_dim"]),
        conv_kernel=tuple(hf["conv_kernel"]),
        conv_stride=tuple(hf["conv_stride"]),
        feat_extract_norm=hf.get("feat_extract_norm",
                                 "layer" if data2vec else "group"),
        conv_bias=hf.get("conv_bias", False),
        num_conv_pos_embeddings=hf["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=hf["num_conv_pos_embedding_groups"],
        do_stable_layer_norm=hf.get("do_stable_layer_norm", False),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        feat_proj_layer_norm=hf.get("feat_proj_layer_norm", True),
        pos_conv_type="stacked" if data2vec else "weight_norm",
        pos_conv_depth=(hf.get("num_conv_pos_embeddings", 5) if data2vec
                        else 5),
        pos_conv_kernel=hf.get("conv_pos_kernel_size", 19),
        rel_pos_bias=model_type == "wavlm",
        num_buckets=hf.get("num_buckets", 320),
        max_bucket_distance=hf.get("max_bucket_distance", 800))


def load_wav2vec2(path, config=None):
    """Load and convert a HF wav2vec2 checkpoint: ``(encoder, config)`` with
    ``encoder`` a filled ``Wav2Vec2Encoder`` on the CPU in f32 (assign it to
    a bridge's ``encoder``). The config is read from ``config.json`` beside
    the checkpoint when there is one, else it is wav2vec2-large-lv60's."""
    if config is None:
        cfg_file = (os.path.join(path, "config.json")
                    if os.path.isdir(path) else None)
        if cfg_file and os.path.exists(cfg_file):
            with open(cfg_file) as f:
                config = config_from_hf(json.load(f))
        else:
            config = Wav2Vec2Config()
    encoder = Wav2Vec2Encoder(config)
    encoder.load_state_dict(
        convert_wav2vec2_state_dict(load_state_dict(path), config),
        strict=True)
    return encoder, config

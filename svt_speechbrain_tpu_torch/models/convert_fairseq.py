"""fairseq AV-HuBERT checkpoints → the port's modules (port of
``svt_speechbrain_tpu/models/convert_fairseq.py``).

The checkpoint's tensors are already in torch layout, so conversion is a
renaming (and a transpose of each linear weight into the port's (in, out)
``Linear.w``): ``convert_avhubert_state_dict`` gives a state dict that
``AVHubertModel.load_state_dict`` takes as it is, the BatchNorm running
statistics among its buffers. The pretraining head (``final_proj``,
``label_embs_concat``) and the BatchNorm batch counters are dropped.
``convert_fairseq_avhubert_asr`` does the same for a seq2seq ASR
checkpoint, encoder and decoder, for ``AVHubertASR.load_state_dict``, and
``convert_wav2vec2_fairseq_state_dict`` for a fairseq wav2vec 2.0
checkpoint, for ``Wav2Vec2Encoder.load_state_dict``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

#: checkpoint keys conversion drops: the pretraining head and cluster
#: embeddings (BatchNorm ``num_batches_tracked`` counters are dropped too)
IGNORED = ("final_proj.weight", "final_proj.bias", "label_embs_concat")


def load_fairseq_state_dict(path):
    """Flat name → tensor dict of a local fairseq checkpoint file (its
    ``"model"`` entry when it has one). A remote source (a URL or a hub
    name that is not a file) raises: nothing is downloaded."""
    if not os.path.isfile(str(path)):
        raise FileNotFoundError(
            f"{path!r} is not a local file; the port reads fairseq "
            f"checkpoints from disk only")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else None
    if not hasattr(sd, "items"):
        raise ValueError(f"Unrecognized checkpoint format at {path}")
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def _t(x):
    return torch.as_tensor(x)


def _linear(sd, src, dst, out):
    out[dst + ".w"] = _t(sd[src + ".weight"]).t()
    out[dst + ".b"] = _t(sd[src + ".bias"])


def _norm(sd, src, dst, out, running=False):
    out[dst + ".scale"] = _t(sd[src + ".weight"])
    out[dst + ".bias"] = _t(sd[src + ".bias"])
    if running:
        out[dst + ".mean"] = _t(sd[src + ".running_mean"])
        out[dst + ".var"] = _t(sd[src + ".running_var"])


def convert_resnet(sd, prefix="feature_extractor_video.resnet.",
                   dst="feature_extractor_video.resnet"):
    """The ``ResEncoder`` entries (frontend3D and the trunk) of a fairseq
    state dict, named for the port's module under ``dst``."""
    out = {f"{dst}.frontend_conv.weight": _t(sd[prefix + "frontend3D.0.weight"]),
           f"{dst}.frontend_act.alpha": _t(sd[prefix + "frontend3D.2.weight"])}
    _norm(sd, prefix + "frontend3D.1", f"{dst}.frontend_bn", out, True)
    for stage in range(1, 5):
        for b in range(2):
            src = f"{prefix}trunk.layer{stage}.{b}."
            blk = f"{dst}.trunk.layer{stage}_{b}."
            for i in (1, 2):
                out[f"{blk}conv{i}.weight"] = _t(sd[f"{src}conv{i}.weight"])
                _norm(sd, f"{src}bn{i}", f"{blk}bn{i}", out, True)
                if f"{src}relu{i}.weight" in sd:
                    out[f"{blk}relu{i}.alpha"] = _t(sd[f"{src}relu{i}.weight"])
            if src + "downsample.0.weight" in sd:
                out[blk + "down_conv.weight"] = _t(sd[src + "downsample.0.weight"])
                _norm(sd, src + "downsample.1", blk + "down_bn", out, True)
    return out


def convert_avhubert_state_dict(sd, config):
    """A fairseq ``av_hubert`` state dict → the state dict of the port's
    ``AVHubertModel(config)`` (``convert_fairseq.py:90``)."""
    out = convert_resnet(sd)
    _linear(sd, "feature_extractor_audio.proj", "feature_extractor_audio.proj",
            out)
    _linear(sd, "feature_extractor_video.proj", "feature_extractor_video.proj",
            out)
    _norm(sd, "layer_norm", "layer_norm", out)
    if "post_extract_proj.weight" in sd:
        _linear(sd, "post_extract_proj", "post_extract_proj", out)
    out["mask_emb"] = (_t(sd["mask_emb"]) if "mask_emb" in sd
                       else torch.zeros(config.audio_feat_dim))
    pc = "encoder.pos_conv.0."
    if pc + "weight_g" in sd:
        g, v = sd[pc + "weight_g"], sd[pc + "weight_v"]
    else:
        g = sd[pc + "parametrizations.weight.original0"]
        v = sd[pc + "parametrizations.weight.original1"]
    out["pos_conv.g"], out["pos_conv.v"] = _t(g), _t(v)
    out["pos_conv.b"] = _t(sd[pc + "bias"])
    _norm(sd, "encoder.layer_norm", "encoder_ln", out)
    for i in range(config.encoder_layers):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for proj, name in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                           ("out_proj", "o")):
            out[f"{dst}attn.w{name}"] = _t(
                sd[f"{src}self_attn.{proj}.weight"]).t()
            out[f"{dst}attn.b{name}"] = _t(sd[f"{src}self_attn.{proj}.bias"])
        _norm(sd, src + "self_attn_layer_norm", dst + "ln1", out)
        _norm(sd, src + "final_layer_norm", dst + "ln2", out)
        _linear(sd, src + "fc1", dst + "ffn1", out)
        _linear(sd, src + "fc2", dst + "ffn2", out)
    return out


def load_avhubert(path, config):
    """``convert_avhubert_state_dict`` of a local checkpoint file."""
    return convert_avhubert_state_dict(load_fairseq_state_dict(path), config)


def convert_wav2vec2_fairseq_state_dict(sd, config):
    """A fairseq ``Wav2Vec2Model`` state dict (keys with or without the
    ``w2v_model.`` prefix of a fine-tuned checkpoint) → the state dict of
    the port's ``Wav2Vec2Encoder(config)`` (``convert_fairseq.py:160``):
    ``feature_extractor.conv_layers.<i>.0`` convs with their norms (``.2``,
    or ``.2.1`` behind fairseq's transpose in "layer" mode; the first conv
    only in "group" mode), ``layer_norm`` and ``post_extract_proj``, the
    weight-normed ``encoder.pos_conv.0`` (``weight_g``/``weight_v`` or the
    parametrization's), ``encoder.layer_norm`` and ``encoder.layers``."""
    sd = {k.removeprefix("w2v_model."): v for k, v in sd.items()}
    out = {}
    for i in range(len(config.conv_dim)):
        pre, dst = (f"feature_extractor.conv_layers.{i}.",
                    f"feature_extractor.layers.{i}.")
        out[dst + "conv.weight"] = _t(sd[pre + "0.weight"])
        if pre + "0.bias" in sd:
            out[dst + "conv.bias"] = _t(sd[pre + "0.bias"])
        norm = pre + ("2.1" if pre + "2.1.weight" in sd else "2")
        if config.feat_extract_norm == "layer":
            _norm(sd, norm, dst + "layer_norm", out)
        elif i == 0:
            _norm(sd, norm, dst + "group_norm", out)
    _norm(sd, "layer_norm", "feat_proj_ln", out)
    _linear(sd, "post_extract_proj", "feat_proj", out)
    pc = "encoder.pos_conv.0."
    if pc + "weight_g" in sd:
        g, v = sd[pc + "weight_g"], sd[pc + "weight_v"]
    else:
        g = sd[pc + "parametrizations.weight.original0"]
        v = sd[pc + "parametrizations.weight.original1"]
    out["pos_conv.g"] = _t(g).reshape(1, 1, -1)
    out["pos_conv.v"], out["pos_conv.b"] = _t(v), _t(sd[pc + "bias"])
    _norm(sd, "encoder.layer_norm", "encoder_ln", out)
    for i in range(config.num_layers):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for proj, name in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                           ("out_proj", "o")):
            out[f"{dst}attn.w{name}"] = _t(
                sd[f"{src}self_attn.{proj}.weight"]).t()
            out[f"{dst}attn.b{name}"] = _t(sd[f"{src}self_attn.{proj}.bias"])
        _norm(sd, src + "self_attn_layer_norm", dst + "ln1", out)
        _norm(sd, src + "final_layer_norm", dst + "ln2", out)
        _linear(sd, src + "fc1", dst + "ffn1", out)
        _linear(sd, src + "fc2", dst + "ffn2", out)
    return {k: v.contiguous() for k, v in out.items()}


def convert_fairseq_seq2seq_decoder(sd, cfg):
    """The ``decoder.*`` keys of a fairseq ``hubert_asr`` seq2seq checkpoint
    → the state dict of the port's ``FairseqTransformerDecoder(cfg)``
    (``convert_fairseq.py:227``): ``embed_tokens.weight``,
    ``layers.N.{self_attn,encoder_attn}.{q,k,v,out}_proj``,
    ``layers.N.{self_attn,encoder_attn,final}_layer_norm``,
    ``layers.N.fc{1,2}``, and as the config asks ``embed_out``,
    ``layer_norm`` and a learned ``embed_positions.weight``. The sinusoidal
    ``embed_positions._float_tensor`` buffer carries nothing and is not
    read."""
    sd = {k.removeprefix("decoder."): v for k, v in sd.items()
          if k.startswith("decoder.")}
    out = {"embed_tokens.table": _t(sd["embed_tokens.weight"])}
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}.", f"layers.{i}."
        for attn in ("self_attn", "encoder_attn"):
            for proj, name in (("q_proj", "q"), ("k_proj", "k"),
                               ("v_proj", "v"), ("out_proj", "o")):
                out[f"{dst}{attn}.w{name}"] = _t(
                    sd[f"{src}{attn}.{proj}.weight"]).t()
                out[f"{dst}{attn}.b{name}"] = _t(sd[f"{src}{attn}.{proj}.bias"])
        _norm(sd, src + "self_attn_layer_norm", dst + "ln_self", out)
        _norm(sd, src + "encoder_attn_layer_norm", dst + "ln_cross", out)
        _norm(sd, src + "final_layer_norm", dst + "ln_final", out)
        _linear(sd, src + "fc1", dst + "fc1", out)
        _linear(sd, src + "fc2", dst + "fc2", out)
    if cfg.learned_pos:
        out["embed_positions.table"] = _t(sd["embed_positions.weight"])
    if not cfg.share_input_output_embed:
        out["embed_out"] = _t(sd["embed_out"])
    if cfg.normalize_before:
        _norm(sd, "layer_norm", "final_ln", out)
    return out


def convert_fairseq_avhubert_asr(sd, encoder_config, decoder_cfg):
    """A whole ``hubert_asr``-style seq2seq state dict (the encoder under
    ``encoder.w2v_model.*``, the decoder under ``decoder.*``) → the state
    dict of the port's ``AVHubertASR`` (``convert_fairseq.py:282``; the JAX
    function returns the encoder's params and state and the decoder's
    params apart)."""
    enc_sd = {k.removeprefix("encoder.w2v_model."): v for k, v in sd.items()
              if k.startswith("encoder.w2v_model.")}
    out = {"encoder." + k: v for k, v in
           convert_avhubert_state_dict(enc_sd, encoder_config).items()}
    out.update({"decoder." + k: v for k, v in
                convert_fairseq_seq2seq_decoder(sd, decoder_cfg).items()})
    return out

"""Offline int8 quantization of a wav2vec2 bridge for serving (port of
``svt_speechbrain_tpu/models/quantize.py``).

Replaces the float weights of the encoder's projection and FFN products by
``(w_q8, w_scale)`` buffers that ``nnet.linear.Linear`` and
``nnet.attention.MultiheadAttention`` dispatch on. Activations are
quantized per token inside ``ops.quant.int8_matmul``, so no calibration set
is needed. Every function returns a quantized copy and leaves its argument
as it was: a caller can keep the float model and make transcribers of
either kind from it. The copy's remaining parameters take no gradient
(``int8_matmul`` refuses an input that requires one).

What is quantized by default: ``ffn1``/``ffn2`` of every layer (most of the
operations) and ``feat_proj``. ``quantize_attn=True`` also quantizes the
q/k/v/out projections; whether that pays on a given card is a measurement,
so it is off by default as in the JAX package. What always stays float: the
conv frontend, the positional conv, all layer norms, biases, the frame
head, and the attention core (score and context products).

Inference only: do not train on the result.

``quantize_fusion`` does the same for the RCA fusion network's FFNs (and,
with ``quantize_attn``, its shared attention's projections).
``quantize_avhubert`` does it for AV-HuBERT: the encoder layers' FFNs (and
attention projections) and ``post_extract_proj``; its ResNet frontend and
the two streams' projections stay float.

Example
-------
>>> import torch
>>> from svt_speechbrain_tpu_torch.models.wav2vec2 import (
...     HuggingFaceWav2Vec2, Wav2Vec2Config)
>>> cfg = Wav2Vec2Config(hidden_size=32, num_layers=2, num_heads=4,
...                      ffn_size=64, conv_dim=(16,) * 7,
...                      num_conv_pos_embeddings=16,
...                      num_conv_pos_embedding_groups=4)
>>> model = HuggingFaceWav2Vec2(config=cfg).eval()
>>> _ = torch.manual_seed(0)
>>> for p in model.parameters():
...     _ = torch.nn.init.normal_(p, std=0.1) if p.dim() > 1 else None
>>> qmodel = quantize_wav2vec2(model)
>>> qmodel.encoder.layers[0].ffn1.w_q8.dtype, hasattr(model.encoder.feat_proj, "w")
(torch.int8, True)
>>> wav = torch.randn(2, 3200)
>>> out, qout = model(wav), qmodel(wav)
>>> bool((out - qout).abs().max() < 0.5)
True
"""
from __future__ import annotations

import copy

from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention
from svt_speechbrain_tpu_torch.ops.quant import quantize_weight

_MHA_WEIGHTS = ("wq", "wk", "wv", "wo")


def _quantize_(module, names):
    """In place: the float matrices ``names`` of ``module`` → int8."""
    for name in names:
        module.to_int8_(name, *quantize_weight(getattr(module, name)))
    return module


def quantize_linear_params(linear):
    """A copy of a ``Linear`` holding ``w_q8``/``w_scale`` instead of ``w``
    (``b`` stays)."""
    return _quantize_(copy.deepcopy(linear), ("w",)).requires_grad_(False)


def quantize_mha_params(mha):
    """A copy of a ``MultiheadAttention`` with its four projection matrices
    quantized (the biases stay)."""
    return _quantize_(copy.deepcopy(mha), _MHA_WEIGHTS).requires_grad_(False)


def quantize_wav2vec2(bridge, quantize_attn=False, quantize_feat_proj=True):
    """A copy of ``bridge`` (a ``HuggingFaceWav2Vec2``, or a bare
    ``Wav2Vec2Encoder``) of any family with int8 FFN weights in every
    layer, an int8 ``feat_proj`` unless ``quantize_feat_proj`` is False, and
    int8 attention projections if ``quantize_attn`` (not WavLM's gated
    attention, which stays float)."""
    out = copy.deepcopy(bridge).requires_grad_(False)
    encoder = getattr(out, "encoder", out)
    for layer in encoder.layers:
        _quantize_(layer.ffn1, ("w",))
        _quantize_(layer.ffn2, ("w",))
        # WavLM's gated attention stays float, as in the JAX package
        # (``quantize.py:81-84``)
        if quantize_attn and isinstance(layer.attn, MultiheadAttention):
            _quantize_(layer.attn, _MHA_WEIGHTS)
    if quantize_feat_proj:
        _quantize_(encoder.feat_proj, ("w",))
    return out


def quantize_fusion(fusion, quantize_attn=False):
    """A copy of a ``FusionRCA`` or ``RCANet`` (``models/fusion.py``) whose
    RCA layers hold int8 FFN weights (``pos_ffn.ffn1``/``ffn2``) and, with
    ``quantize_attn``, int8 projections in their shared attention
    (``quantize.py:123``). On the card each quantized product is one launch
    of kernel 5: 4 a forward, 12 with ``quantize_attn``.

    Example
    -------
    >>> from svt_speechbrain_tpu_torch.models.fusion import FusionRCA
    >>> q = quantize_fusion(FusionRCA(alpha=0.5, nhead=4, d_ffn=32,
    ...                               d_model=16))
    >>> q.fusion.layer1.pos_ffn.ffn1.w_q8.dtype
    torch.int8
    """
    from svt_speechbrain_tpu_torch.models.fusion import RCALayer

    out = copy.deepcopy(fusion).requires_grad_(False)
    for layer in out.modules():
        if isinstance(layer, RCALayer):
            _quantize_(layer.pos_ffn.ffn1, ("w",))
            _quantize_(layer.pos_ffn.ffn2, ("w",))
            if quantize_attn:
                _quantize_(layer.self_att, _MHA_WEIGHTS)
    return out


def quantize_avhubert(model, quantize_attn=False):
    """A copy of a ``FairseqAVHubert`` or ``AVHubertModel``
    (``models/avhubert.py``) with int8 ``ffn1``/``ffn2`` in every encoder
    layer, an int8 ``post_extract_proj`` when the model has one, and with
    ``quantize_attn`` int8 attention projections (``quantize.py:100``). The
    ResNet frontend, the audio and video projections, the positional conv
    and the norms stay float. On the card each quantized product is one
    launch of kernel 5: 2 a layer and 1 more, 49 an utterance for
    AV-HuBERT large, 145 with ``quantize_attn``.

    Example
    -------
    >>> from svt_speechbrain_tpu_torch.models.avhubert import (
    ...     AVHubertConfig, FairseqAVHubert)
    >>> q = quantize_avhubert(FairseqAVHubert(AVHubertConfig(
    ...     encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
    ...     encoder_attention_heads=4, conv_pos=8, conv_pos_groups=2)))
    >>> q.model.post_extract_proj.w_q8.dtype, hasattr(q.model.layers[0].ffn1, "w")
    (torch.int8, False)
    """
    out = copy.deepcopy(model).requires_grad_(False)
    inner = getattr(out, "model", out)
    for layer in inner.layers:
        _quantize_(layer.ffn1, ("w",))
        _quantize_(layer.ffn2, ("w",))
        if quantize_attn:
            _quantize_(layer.attn, _MHA_WEIGHTS)
    if inner.post_extract_proj is not None:
        _quantize_(inner.post_extract_proj, ("w",))
    return out

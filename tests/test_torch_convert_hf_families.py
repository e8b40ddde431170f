"""Port parity, ``models/convert_hf.py`` over every family the bridge names:
a HF checkpoint directory (``config.json`` + ``pytorch_model.bin``) with the
key names and shapes of each family's manifest
(``tests/fixtures/ckpt_manifests.json``: wav2vec2-base, hubert-large-ll60k,
data2vec-audio-large-960h, wavlm-large), cut to 2 layers at full width,
read by both packages' ``load_wav2vec2``. The configs must be equal, every
key but ``masked_spec_embed`` must be consumed, and the port's filled
encoder must export the JAX conversion leaf for leaf (``convert_jax``),
bit for bit: conversion only moves and transposes values."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.models import convert_hf as jconvert_hf

from svt_speechbrain_tpu_torch.convert_jax import _flatten, module_tree
from svt_speechbrain_tpu_torch.models import convert_hf
from svt_speechbrain_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                       config_for_name)
from tests.torch_threads import two_torch_threads  # noqa: F401

MANIFESTS = Path(__file__).parent / "fixtures" / "ckpt_manifests.json"
LAYERS = 2
_SCHEDULE = dict(conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                 conv_stride=[5, 2, 2, 2, 2, 2, 2], layer_norm_eps=1e-5)
_BASE = dict(hidden_size=768, num_attention_heads=12, intermediate_size=3072)
_LARGE = dict(hidden_size=1024, num_attention_heads=16,
              intermediate_size=4096)
# the architecture entries of each family's HF config.json
HF_CONFIGS = {
    "wav2vec2-base": dict(
        model_type="wav2vec2", **_BASE, feat_extract_norm="group",
        conv_bias=False, do_stable_layer_norm=False,
        num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16),
    "hubert-large-ll60k": dict(
        model_type="hubert", **_LARGE, feat_extract_norm="layer",
        conv_bias=True, do_stable_layer_norm=True, feat_proj_layer_norm=True,
        num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16),
    # data2vec-audio's config has no feat_extract_norm nor
    # do_stable_layer_norm; num_conv_pos_embeddings is the depth of its
    # stacked positional convs
    "data2vec-audio-large-960h": dict(
        model_type="data2vec-audio", **_LARGE, conv_bias=False,
        num_conv_pos_embeddings=5, conv_pos_kernel_size=19,
        num_conv_pos_embedding_groups=16),
    "wavlm-large": dict(
        model_type="wavlm", **_LARGE, feat_extract_norm="layer",
        conv_bias=False, do_stable_layer_norm=True, num_buckets=320,
        max_bucket_distance=800, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16),
}
PREFIX = {"wav2vec2-base": "wav2vec2.", "hubert-large-ll60k": "hubert.",
          "data2vec-audio-large-960h": "data2vec_audio.",
          "wavlm-large": "wavlm."}


def _state_dict(family):
    """Random tensors under the family's manifest names and shapes, layers
    past ``LAYERS`` left out, with the model prefix of a HF checkpoint."""
    manifest = json.loads(MANIFESTS.read_text())[family]
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for key, shape in sorted(manifest.items()):
        if key.startswith("encoder.layers.") \
                and int(key.split(".")[2]) >= LAYERS:
            continue
        sd[PREFIX[family] + key] = torch.randn(shape, generator=gen)
    return sd


@pytest.fixture(scope="module", params=list(HF_CONFIGS))
def checkpoint(request, tmp_path_factory):
    family = request.param
    path = tmp_path_factory.mktemp(family)
    hf = dict(HF_CONFIGS[family], num_hidden_layers=LAYERS, **_SCHEDULE)
    (path / "config.json").write_text(json.dumps(hf))
    sd = _state_dict(family)
    torch.save(sd, path / "pytorch_model.bin")
    return family, hf, sd, str(path)


def test_config_from_hf_matches_jax_and_the_name(checkpoint):
    family, hf, _, path = checkpoint
    config = convert_hf.config_from_hf(hf)
    _, jconfig = jconvert_hf.load_wav2vec2(path)
    names = [f.name for f in dataclasses.fields(Wav2Vec2Config)]
    assert dataclasses.asdict(config) == {n: getattr(jconfig, n)
                                          for n in names}
    named = dataclasses.replace(config_for_name(family), num_layers=LAYERS)
    if config.pos_conv_type == "stacked":
        # data2vec's num_conv_pos_embeddings is its depth, read into
        # pos_conv_depth; the field itself is unused by the stacked convs
        named = dataclasses.replace(
            named, num_conv_pos_embeddings=config.num_conv_pos_embeddings)
    assert config == named


def test_every_key_is_consumed_and_equals_the_jax_conversion(checkpoint):
    family, hf, sd, path = checkpoint
    config = convert_hf.config_from_hf(hf)
    # each random tensor is told by its size and sum, which a transpose
    # keeps: the outputs are the inputs but masked_spec_embed, each once
    def signature(t):
        return t.numel(), round(float(t.double().sum()), 6)

    out = convert_hf.convert_wav2vec2_state_dict(sd, config)
    assert sorted(map(signature, out.values())) == sorted(
        signature(t) for k, t in sd.items()
        if not k.endswith("masked_spec_embed"))
    encoder, loaded = convert_hf.load_wav2vec2(path)
    assert loaded == config
    want = _flatten(jconvert_hf.load_wav2vec2(path)[0])
    got = _flatten(module_tree(encoder))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value),
                                      err_msg=key)

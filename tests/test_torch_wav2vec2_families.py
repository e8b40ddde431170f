"""Port parity, the SSL encoder families and options: wav2vec2-base ("group"
extractor, post-LN), data2vec-audio (stacked positional convs, no conv
bias), WavLM base and large (gated relative position bias),
``feat_proj_layer_norm=False``, AV-HuBERT base (post-LN) and ``remat`` /
``remat_frontend``, against the JAX package on the CPU in f32, at TINY
widths (``TINY_ARCH``, 2 layers) over each family's own options. The
weights are JAX-initialised (each package's ``init``), carried into the
port by ``convert_jax.load_module_tree``; the inputs are seeded numpy.
The training steps are in ``test_torch_wav2vec2_families_steps.py``, with
this file's tolerances.

Tolerances:
- forwards: ATOL absolute on unit-scale features (f32, summation order);
- the ``AudioAMT`` step: the loss within LOSS_RTOL, each parameter's
  gradient within GRAD_RTOL of its own norm, except leaves whose reference
  gradient is under ZERO_GRAD_SHARE of the global norm (0 in exact
  arithmetic: the attention's key bias) and are float noise on both sides;
- the port's remat against its own run without remat: bit for bit, with
  every dropout at 0.1 and the same generators.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import avhubert as javhubert
from svt_speechbrain_tpu.models import quantize as jquantize
from svt_speechbrain_tpu.models import wav2vec2 as jw2v

from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, init_avhubert, init_wav2vec2, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.models import avhubert, quantize
from svt_speechbrain_tpu_torch.models import wav2vec2 as w2v
from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention
from tests.torch_threads import two_torch_threads  # noqa: F401

ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
ZERO_GRAD_SHARE = 1e-6
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0,
                  activation_dropout=0.0, feat_proj_dropout=0.0)
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1,
               activation_dropout=0.1, feat_proj_dropout=0.1)
SAMPLES = 8000

# (classmethod, overrides): each family in its TINY form
FAMILIES = {
    "base": ("base", {}),
    "data2vec": ("data2vec_audio_large", {}),
    "wavlm_base": ("wavlm_base", {}),
    "wavlm_large": ("wavlm_large", {}),
    "no_feat_proj_ln": ("hubert_large", dict(feat_proj_layer_norm=False)),
}


def _configs(family, **extra):
    """(JAX config, port config) of a family at TINY widths."""
    make, overrides = FAMILIES[family]
    jcfg = dataclasses.replace(getattr(jw2v.Wav2Vec2Config, make)(),
                               **w2v.TINY_ARCH, **overrides, **extra)
    names = {f.name for f in dataclasses.fields(w2v.Wav2Vec2Config)}
    return jcfg, w2v.Wav2Vec2Config(**{n: getattr(jcfg, n) for n in names})


def _bridges(family, **extra):
    """The JAX bridge with its JAX-initialised params and the port's bridge
    holding them."""
    jcfg, cfg = _configs(family, **NO_DROPOUT, **extra)
    jb = jw2v.HuggingFaceWav2Vec2(config=jcfg, normalize_wav=True)
    params = jb.init(jax.random.PRNGKey(0))
    tb = w2v.HuggingFaceWav2Vec2(config=cfg, normalize_wav=True)
    load_module_tree(tb, jax.tree_util.tree_map(np.asarray, params))
    return jb, params, tb.eval()


def _wavs(batch, samples, seed):
    return np.random.default_rng(seed).normal(
        size=(batch, samples)).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_matches_jax(family):
    """With exact lengths (every row's valid frames) and without (norms
    over the whole batch)."""
    jb, params, tb = _bridges(family)
    wav = _wavs(3, SAMPLES, 1)
    lens = np.asarray([1.0, 0.55, 0.8], np.float32)
    want = np.asarray(jax.jit(lambda p, w, l: jb(p, w, wav_lens=l))(
        params, wav, lens))
    want_batch = np.asarray(jax.jit(jb)(params, wav))
    with torch.no_grad():
        got = tb(torch.from_numpy(wav), wav_lens=torch.from_numpy(lens))
        got_batch = tb(torch.from_numpy(wav))
    frames = tb.config.output_length_tensor(
        torch.round(torch.from_numpy(lens) * SAMPLES).int()).tolist()
    for row, n in enumerate(frames):
        np.testing.assert_allclose(got[row, :n].numpy(), want[row, :n],
                                   atol=ATOL, err_msg=f"row {row}")
    np.testing.assert_allclose(got_batch.numpy(), want_batch, atol=ATOL)


@pytest.mark.parametrize("family", ["base", "wavlm_base"])
def test_padded_row_equals_the_row_alone(family):
    """Exact lengths: a row padded to the batch's length gives its
    unpadded forward; in "group" mode this holds only because the group
    statistics skip the padded frames (``_masked_group_norm``). (data2vec's
    stacked positional convs carry content into the zeroed padding and back
    from the second conv on, in both packages, so it is held to the JAX
    package only.)"""
    _, _, tb = _bridges(family)
    wav = _wavs(2, SAMPLES, 3)
    short = int(0.6 * SAMPLES)
    with torch.no_grad():
        batch = tb(torch.from_numpy(wav),
                   wav_lens=torch.tensor([1.0, short / SAMPLES]))
        alone = tb(torch.from_numpy(wav[1:, :short]),
                   wav_lens=torch.tensor([1.0]))
        plain = tb.encoder.feature_extractor(torch.from_numpy(wav[1:, :short]),
                                             fused=False)
    n = alone.shape[1]
    assert n == tb.config.output_length(short)
    np.testing.assert_allclose(batch[1, :n].numpy(), alone[0].numpy(),
                               atol=1e-5)
    if tb.config.feat_extract_norm == "group":
        with torch.no_grad():
            masked = tb.encoder.feature_extractor(
                torch.from_numpy(wav[1:, :short]), fused=False,
                true_samples=torch.tensor([short]))
        np.testing.assert_allclose(masked.numpy(), plain.numpy(), atol=1e-6)


def test_avhubert_base_matches_jax():
    """AV-HuBERT base's post-LN encoder (``encoder_ln`` before the layers),
    audio stream with the video stream zero-filled, at TINY widths; and
    ``quantize_avhubert`` over its tree."""
    tiny = dict(encoder_layers=2, encoder_embed_dim=16,
                encoder_ffn_embed_dim=32, encoder_attention_heads=4,
                audio_feat_dim=10, conv_pos=8, conv_pos_groups=2, dropout=0.0,
                attention_dropout=0.0, activation_dropout=0.0,
                dropout_input=0.0)
    jcfg = dataclasses.replace(javhubert.AVHubertConfig.base(), **tiny)
    cfg = dataclasses.replace(avhubert.AVHubertConfig.base(), **tiny)
    assert not cfg.layer_norm_first and cfg == avhubert.AVHubertConfig(
        **dataclasses.asdict(jcfg))
    tree, state = init_avhubert(cfg, torch.Generator().manual_seed(0))
    jm = javhubert.AVHubertModel(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = avhubert.AVHubertModel(cfg)
    load_module_tree(model, tree, state)
    audio = np.random.default_rng(0).normal(size=(2, 7, 10)).astype(
        np.float32)
    want, _ = jax.jit(lambda p, a: jm.extract_finetune(
        p, jm.init_state(), {"audio": a}))(params, audio)
    with torch.no_grad():
        got = model.eval().extract_finetune({"audio": torch.from_numpy(audio)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    got_q = _flatten(module_tree(quantize.quantize_avhubert(
        model, quantize_attn=True)))
    want_q = _flatten(jax.tree_util.tree_map(np.asarray, jquantize
                                             .quantize_avhubert(
                                                 params, quantize_attn=True)))
    assert sorted(got_q) == sorted(want_q)
    for key, value in want_q.items():
        np.testing.assert_array_equal(got_q[key], value, err_msg=key)


def test_fairseq_converter_at_avhubert_base_width():
    """The AV-HuBERT large checkpoint's keys at base widths (768, 3072,
    fused 1536; positional conv (768, 48, 128)), 2 layers: every key but
    the pretraining head consumed, the result exactly the names and shapes
    of the port's base ``AVHubertModel`` state dict. Each key's tensor is
    one tag value, broadcast."""
    import json
    from pathlib import Path

    from svt_speechbrain_tpu_torch.models import convert_fairseq

    widths = {1024: 768, 4096: 3072, 2048: 1536}
    manifest = json.loads((Path(__file__).parent / "fixtures"
                           / "ckpt_manifests.json").read_text())[
                               "avhubert-large"]
    sd, tags = {}, {}
    for i, (key, shape) in enumerate(sorted(manifest.items()), start=1):
        if key.startswith("encoder.layers.") and int(key.split(".")[2]) >= 2:
            continue
        if "resnet" not in key:
            shape = [widths.get(n, n) for n in shape]
        if key == "encoder.pos_conv.0.weight_v":
            shape = [768, 48, 128]
        sd[key] = torch.tensor(float(i)).expand(shape)
        tags[float(i)] = key
    cfg = dataclasses.replace(avhubert.AVHubertConfig.base(),
                              encoder_layers=2)
    out = convert_fairseq.convert_avhubert_state_dict(sd, cfg)
    seen = {tags[float(t.amin())] for t in out.values()}
    assert all(float(t.amin()) == float(t.amax()) for t in out.values())
    dropped = {k for k in set(sd) - seen
               if not k.endswith("num_batches_tracked")}
    assert dropped == set(convert_fairseq.IGNORED)
    with torch.device("meta"):
        model = avhubert.AVHubertModel(cfg)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("family", ["base", "wavlm_large"])
def test_quantize_matches_jax(family):
    """``quantize_wav2vec2(quantize_attn=True)`` over the post-LN / "group"
    and WavLM trees: the same int8 weights and scales as the JAX tree, the
    WavLM attention left float in both."""
    _, params, tb = _bridges(family)
    got = _flatten(module_tree(quantize.quantize_wav2vec2(
        tb, quantize_attn=True)))
    want = _flatten(jax.tree_util.tree_map(np.asarray,
                                           jquantize.quantize_wav2vec2(
                                               params, quantize_attn=True)))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    wavlm = tb.config.rel_pos_bias
    assert any(k.endswith("attn/wq_q8") for k in got) != wavlm
    assert ("encoder/layers/0/attn/wq" in got) == wavlm


# ------------------------------------------------------------- name check
NAMES = ["facebook/wav2vec2-large-lv60", "facebook/wav2vec2-base",
         "facebook/wav2vec2-base-960h", "facebook/hubert-large-ll60k",
         "facebook/hubert-base-ls960", "facebook/data2vec-audio-large-960h",
         "facebook/data2vec-audio-base", "microsoft/wavlm-large",
         "microsoft/wavlm-base-plus", "microsoft/wavlm-base", None]


@pytest.mark.parametrize("name", NAMES)
def test_name_picks_the_jax_family_and_wav_norm(name):
    jb = jw2v.HuggingFaceWav2Vec2(source=name)
    names = {f.name for f in dataclasses.fields(w2v.Wav2Vec2Config)}
    want = {n: getattr(jb.config, n) for n in names}
    assert dataclasses.asdict(w2v.config_for_name(name)) == want
    assert w2v.normalizes_wav(name) == jb.normalize_wav
    small = dict(num_layers=1, hidden_size=32, num_heads=4, ffn_size=64,
                 num_conv_pos_embeddings=8)
    tb = w2v.HuggingFaceWav2Vec2(source=name, arch_overrides=small)
    assert tb.normalize_wav == jb.normalize_wav
    assert tb.config == dataclasses.replace(w2v.config_for_name(name),
                                            **small)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("family", list(FAMILIES))
def test_seeded_tree_has_the_jax_structure(family):
    jcfg, cfg = _configs(family)
    ours = init_wav2vec2(cfg, torch.Generator().manual_seed(0))
    theirs = jax.eval_shape(jw2v.HuggingFaceWav2Vec2(config=jcfg).init,
                            jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), ours)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), theirs)
    bridge = w2v.HuggingFaceWav2Vec2(config=cfg)
    load_module_tree(bridge, ours)
    back = _flatten(module_tree(bridge))
    for key, value in _flatten(ours).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_act_sharding_alone_is_refused():
    """Every family builds with activation sharding; outside a device mesh
    its forward raises, as the JAX sharding constraint does."""
    for make in ("base", "data2vec_audio_large", "wavlm_large"):
        cfg = dataclasses.replace(getattr(w2v.Wav2Vec2Config, make)(),
                                  **w2v.TINY_ARCH,
                                  act_sharding=("data", None, None))
        bridge = w2v.HuggingFaceWav2Vec2(config=cfg).eval()
        encoder = w2v.Wav2Vec2Encoder(cfg)
        with pytest.raises(RuntimeError, match="active device mesh"), \
                torch.no_grad():
            bridge(torch.ones(1, 3200))
        with pytest.raises(RuntimeError, match="active device mesh"), \
                torch.no_grad():
            encoder(torch.ones(1, 3200), False)


def test_wavlm_attention_never_reaches_the_kernels(monkeypatch):
    """WavLM's biased attention is eager: the attention kernels' wrappers
    are not called, and the standard families' layers do call them."""
    from svt_speechbrain_tpu_torch.ops import flash_attention as fa

    calls = []
    for name in ("flash_attention", "flash_attention_short"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, functools.partial(
            lambda f, n, *a, **k: (calls.append(n), f(*a, **k))[1], real,
            name))
    for family, reached in (("wavlm_large", False), ("data2vec", True)):
        calls.clear()
        _, _, tb = _bridges(family)
        with torch.no_grad():
            tb(torch.from_numpy(_wavs(1, SAMPLES, 0)))
        assert bool(calls) == reached, family
        assert isinstance(tb.encoder.layers[0].attn,
                          MultiheadAttention) == reached


@pytest.mark.parametrize("t", [249, 1499])
def test_wavlm_buckets_equal_the_jax_table(t):
    """The relative position buckets, element for element, at the 5 s
    chunk's frames and the 30 s window's."""
    got = w2v._wavlm_relative_position_buckets(t, 320, 800)
    want = jw2v._wavlm_relative_position_buckets(t, 320, 800)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() < 320

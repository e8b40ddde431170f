"""Port parity, AV-HuBERT seq2seq ASR (``models/avhubert_asr.py``) against
the JAX package on the CPU: a TINY ``AVHubertASR`` of both packages on one
seeded tree of the JAX shapes (``convert_jax.init_avhubert_asr``, loaded
into the port by ``load_module_tree`` with the state tree),
``transcribe`` on the same seeded audio features and 32×32 lip ROIs (audio
only, video only, both, with ``frame_lengths``, on the device search, with
a stub tokenizer); ``from_fairseq`` on a TINY fairseq-named state dict; the
full ``avhubert-asr-seq2seq`` manifest converted shape for shape, one tag
value broadcast per key.

Tolerances: tokens exact; scores within ATOL (the encoder features agree
within FEAT_ATOL, as in ``test_torch_video_models.py``, and the decoder's
log-probabilities within 1e-5 of each other over them).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from svt_speechbrain_tpu.models import avhubert as javhubert
from svt_speechbrain_tpu.models import avhubert_asr as jasr
from svt_speechbrain_tpu.models import seq2seq_decoder as jdec

from svt_speechbrain_tpu_torch.convert_jax import (
    init_avhubert_asr, load_module_tree, _flatten)
from svt_speechbrain_tpu_torch.models import avhubert as tavhubert
from svt_speechbrain_tpu_torch.models import avhubert_asr as tasr
from svt_speechbrain_tpu_torch.models import convert_fairseq
from svt_speechbrain_tpu_torch.models import seq2seq_decoder as tdec

from tests.test_torch_video_avhubert import _fairseq_sd
from tests.torch_threads import two_torch_threads  # noqa: F401

ATOL = 1e-5
FEAT_ATOL = 1e-4
MANIFESTS = Path(__file__).resolve().parent / "fixtures" / \
    "ckpt_manifests.json"
ENC = dict(encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
           encoder_attention_heads=2, audio_feat_dim=8)
DEC = dict(vocab_size=13, embed_dim=16, ffn_dim=32, num_layers=1,
           num_heads=2, normalize_before=False, no_scale_embedding=True)
GEN = dict(beam_size=2, max_len_b=6)


@pytest.fixture(scope="module")
def models():
    """Both packages' models on one seeded tree of the JAX ``init``'s shapes
    (``init_avhubert_asr``; drawing it with JAX's ResNet init costs ~10 s)."""
    jm = jasr.AVHubertASR(javhubert.AVHubertConfig(**ENC),
                          jdec.FairseqDecoderConfig(**DEC), **GEN)
    tm = tasr.AVHubertASR(tavhubert.AVHubertConfig(**ENC),
                          tdec.FairseqDecoderConfig(**DEC), **GEN)
    params, state = init_avhubert_asr(tm.encoder_config, tm.decoder_config,
                                      torch.Generator().manual_seed(0))
    load_module_tree(tm, params, state=state)
    return jm, params, state["encoder"], tm.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((2, 10, 8)).astype(np.float32)
    video = rng.standard_normal((2, 10, 32, 32, 1)).astype(np.float32)
    return audio, video


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert [np.asarray(h["tokens"]).tolist() for h in w] == \
            [h["tokens"].tolist() for h in g]
        np.testing.assert_allclose([h["score"] for h in g],
                                   [h["score"] for h in w], rtol=0, atol=ATOL)


CASES = {
    "audio": dict(audio=True),
    "video_lengths": dict(video=True, frame_lengths=[10, 7]),
    "both_lengths_device": dict(audio=True, video=True,
                                frame_lengths=[6, 10], device_search=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transcribe_matches_jax(models, inputs, case):
    jm, params, state, tm = models
    audio, video = inputs
    kw = dict(CASES[case])
    a = audio if kw.pop("audio", False) else None
    v = video if kw.pop("video", False) else None
    want = jm.transcribe(params, state, audio=a, video=v, **kw)
    got = tm.transcribe(audio=a, video=v, **kw)
    _same(want, got)
    feats_j = jm.encode(params, state, audio=a, video=v)
    np.testing.assert_allclose(tm.encode(audio=a, video=v).numpy(),
                               np.asarray(feats_j), rtol=0, atol=FEAT_ATOL)


class _Tokenizer:
    def decode_ids(self, ids):
        return " ".join(f"t{i}" for i in ids)


def test_transcribe_with_tokenizer_matches_jax(models, inputs):
    jm, params, state, tm = models
    audio, _ = inputs
    want = jm.transcribe(params, state, audio=audio, tokenizer=_Tokenizer())
    got = tm.transcribe(audio=audio, tokenizer=_Tokenizer())
    assert got == want and all(isinstance(s, str) for s in got)


def test_encode_needs_a_modality(models):
    with pytest.raises(ValueError, match="audio and/or video"):
        models[3].encode()


def _fairseq_asr_sd(params, state):
    """A fairseq ``av_hubert_seq2seq`` state dict of a TINY JAX tree."""
    t = lambda x: np.ascontiguousarray(np.asarray(x).T)
    sd = {"encoder.w2v_model." + k: v
          for k, v in _fairseq_sd(params["encoder"], state).items()}
    dp = params["decoder"]
    sd["decoder.embed_tokens.weight"] = dp["embed_tokens"]["table"]
    sd["decoder.embed_out"] = dp["embed_out"]
    sd["decoder.embed_positions._float_tensor"] = np.zeros(1, np.float32)
    for i, lp in dp["layers"].items():
        pre = f"decoder.layers.{i}."
        for attn in ("self_attn", "encoder_attn"):
            for proj, n in (("q_proj", "q"), ("k_proj", "k"),
                            ("v_proj", "v"), ("out_proj", "o")):
                sd[f"{pre}{attn}.{proj}.weight"] = t(lp[attn][f"w{n}"])
                sd[f"{pre}{attn}.{proj}.bias"] = lp[attn][f"b{n}"]
        for ln, n in (("self_attn_layer_norm", "ln_self"),
                      ("encoder_attn_layer_norm", "ln_cross"),
                      ("final_layer_norm", "ln_final")):
            sd[f"{pre}{ln}.weight"] = lp[n]["scale"]
            sd[f"{pre}{ln}.bias"] = lp[n]["bias"]
        for fc in ("fc1", "fc2"):
            sd[f"{pre}{fc}.weight"] = t(lp[fc]["w"])
            sd[f"{pre}{fc}.bias"] = lp[fc]["b"]
    return {k: np.asarray(v) for k, v in sd.items()}


def test_from_fairseq_matches_jax(models, inputs, tmp_path):
    """The same fairseq-named state dict through both packages'
    ``from_fairseq``: the port's module equals the one loaded from the JAX
    tree, and both decode alike; a file loads as the dict does."""
    jm, params, state, tm = models
    audio, video = inputs
    sd = _fairseq_asr_sd(params, state)
    jm2, jp, js = jasr.AVHubertASR.from_fairseq(
        sd, javhubert.AVHubertConfig(**ENC), jdec.FairseqDecoderConfig(**DEC),
        **GEN)
    tm2 = tasr.AVHubertASR.from_fairseq(
        {k: torch.tensor(v) for k, v in sd.items()},
        tavhubert.AVHubertConfig(**ENC), tdec.FairseqDecoderConfig(**DEC),
        device="cpu", **GEN)
    loaded = tm.state_dict()
    for k, v in tm2.state_dict().items():
        assert torch.equal(v, loaded[k]), k
    _same(jm2.transcribe(jp, js, audio=audio, video=video),
          tm2.transcribe(audio=audio, video=video))
    path = tmp_path / "asr.pt"
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}},
               path)
    tm3 = tasr.AVHubertASR.from_fairseq(
        str(path), tavhubert.AVHubertConfig(**ENC),
        tdec.FairseqDecoderConfig(**DEC), device="cpu", **GEN)
    for k, v in tm3.state_dict().items():
        assert torch.equal(v, loaded[k]), k


def test_full_manifest_converts_shape_for_shape():
    """Every key of the ``avhubert-asr-seq2seq`` manifest (694: AV-HuBERT
    large under ``encoder.w2v_model.``, the 6 × 1024 decoder, V 1000) is
    consumed but the sinusoidal ``_float_tensor`` buffer and the BatchNorm
    batch counters, into exactly the names and shapes of the port's default
    ``AVHubertASR``."""
    with open(MANIFESTS) as f:
        manifest = json.load(f)["avhubert-asr-seq2seq"]
    assert len(manifest) == 694
    sd, tags = {}, {}
    for i, (key, shape) in enumerate(sorted(manifest.items()), start=1):
        sd[key] = torch.tensor(float(i)).expand(shape)
        tags[float(i)] = key
    out = convert_fairseq.convert_fairseq_avhubert_asr(
        sd, tavhubert.AVHubertConfig.large(), tasr.default_decoder_config())
    seen = set()
    for name, tensor in out.items():
        assert all(s == 0 for s in tensor.stride()), name   # one tag value
        seen.add(tags[float(tensor[(0,) * tensor.dim()])])
    dropped = {k for k in set(manifest) - seen
               if not k.endswith("num_batches_tracked")}
    assert dropped == {"decoder.embed_positions._float_tensor"}
    with torch.device("meta"):
        model = tasr.AVHubertASR()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in out.items()} == want
    assert out["decoder.embed_out"].shape == (1000, 1024)


def test_seeded_init_has_the_jax_tree_shapes():
    jm = jasr.AVHubertASR(javhubert.AVHubertConfig(**ENC),
                          jdec.FairseqDecoderConfig(**DEC))
    params, state = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    drawn_p, drawn_s = init_avhubert_asr(
        tavhubert.AVHubertConfig(**ENC), tdec.FairseqDecoderConfig(**DEC),
        torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in _flatten(drawn_p).items()} == \
        {k: v.shape for k, v in _flatten(params).items()}
    assert {k: v.shape for k, v in _flatten(drawn_s["encoder"]).items()} == \
        {k: v.shape for k, v in _flatten(state).items()}


def test_from_fairseq_runs_on_the_card_unless_asked():
    """``from_fairseq`` puts the model on the card by default: without one
    it raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    params, state = init_avhubert_asr(
        tavhubert.AVHubertConfig(**ENC), tdec.FairseqDecoderConfig(**DEC),
        torch.Generator().manual_seed(1))
    sd = {k: torch.tensor(v)
          for k, v in _fairseq_asr_sd(params, state["encoder"]).items()}
    with pytest.raises((RuntimeError, AssertionError)):
        tasr.AVHubertASR.from_fairseq(sd, tavhubert.AVHubertConfig(**ENC),
                                      tdec.FairseqDecoderConfig(**DEC))

"""Port parity, the ASR and VAD interfaces of ``pretrained/interfaces.py``:
``EncoderASR`` over a TINY lv60 (``TINY_ARCH``) with a CTC head and an
``spm_lite`` tokenizer (log-posteriors, hypotheses and words; read from an
export folder by ``from_hparams``; ``transcribe_file``),
``EncoderDecoderASR`` over a TINY conformer ``TransformerASR`` and
``S2STransformerBeamSearch`` (hypotheses and words), and ``VAD`` over a
TINY CRDNN with Fbank and a global ``InputNormalization`` holding seeded
statistics (posteriors against the JAX modules called with
``train=False``, equal boundaries), each against the JAX interface on the
same seeded numpy inputs and the port's seeded weights carried across by
``convert_jax.module_tree``, on the CPU, f32.

The port's ``VAD`` normalizes with the stored statistics and leaves them
unchanged; the JAX ``VAD`` updates them at every call (ROADMAP.md queue 3):
both pinned here. The JAX stub test of the hysteresis and segment helpers
(``tests/test_pretrained_interfaces.py::test_vad_segments``) is mirrored.

Tolerances: f32 log-posteriors, encoder states and speech posteriors of
order 1 within 1e-5 (summation order only); hypotheses, words and
boundaries equal; beam scores within 1e-5."""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke as cs
from svt_speechbrain_tpu import pretrained as jpre
from svt_speechbrain_tpu.decoders import ctc as jctc
from svt_speechbrain_tpu.decoders import seq2seq as jsearch
from svt_speechbrain_tpu.models import convolution as jconv
from svt_speechbrain_tpu.models import crdnn as jcrdnn
from svt_speechbrain_tpu.models import features as jlobes
from svt_speechbrain_tpu.models import transformer_asr as jasr
from svt_speechbrain_tpu.models import wav2vec2 as jw2v
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.processing import features as jfeat
from svt_speechbrain_tpu.tokenizers import spm_lite as jlite

from svt_speechbrain_tpu_torch import pretrained as tpre
from svt_speechbrain_tpu_torch.convert_jax import load_module_tree, module_tree
from svt_speechbrain_tpu_torch.dataio.dataio import read_audio, write_audio
from svt_speechbrain_tpu_torch.decoders import ctc as tctc
from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH
from tests.torch_threads import two_torch_threads  # noqa: F401

ATOL = 1e-5
SR = 16000
CTC_PIECES = 80
WAVS_SECONDS = (0.5, 0.4, 0.28)
# TINY conformer: the phase-23 assembly at test_torch_transformer_asr's
# widths, over a 60-piece tokenizer
E2E_ARCH = dict(cs.CONFORMER_ARCH, d_model=8, nhead=2, num_encoder_layers=2,
                num_decoder_layers=1, d_ffn=16, kernel_size=3, dropout=0.0)
E2E_FRONT = dict(cs.CONFORMER_FRONT, out_channels=(2, 3))
E2E_MELS, E2E_PIECES, E2E_STEPS = 12, 60, 4
# TINY VAD: vad-crdnn-libriparty's layout at narrower widths
VAD_ARCH = dict(cs.VAD_ARCH, input_size=16, cnn_channels=(3, 4),
                rnn_neurons=6, dnn_neurons=5)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rows(seconds, seed=0):
    return cs.speech_rows(np.random.default_rng(seed), seconds)


class _JaxModule:
    """A JAX-package module of this test: ``init`` gives the carried
    tree; the call is ``fn(params, *args, **kwargs)``."""

    def __init__(self, fn, params=None):
        self.fn, self.params = fn, params or {}

    def init(self, rng):
        return self.params

    def __call__(self, params, *args, **kwargs):
        return self.fn(params, *args, **kwargs)


def tokenizers(tmp_path, pieces, seed):
    """The seeded unigram model of ``chip_smoke.seeded_unigram``, loaded by
    the port's and by the JAX package's ``spm_lite``."""
    path = str(tmp_path / f"unigram_{pieces}.model")
    tok = cs.seeded_unigram(path, pieces, seed)
    jtok = jlite.SentencePieceProcessor()
    jtok.load(path)
    return tok, jtok


def tiny_ctc_encoder(seed=3):
    """The port's TINY lv60 CTC encoder, seeded, and its JAX twin."""
    enc = cs.ctc_encoder(TINY_ARCH, CTC_PIECES)
    cs._seeded({"encoder": enc}, seed)
    w2v = jw2v.HuggingFaceWav2Vec2(
        config=dataclasses.replace(jw2v.Wav2Vec2Config.large_lv60(),
                                   **TINY_ARCH), normalize_wav=True)
    lin = JLinear(CTC_PIECES, TINY_ARCH["hidden_size"])

    @jax.jit
    def call(params, wavs, lengths):
        feats = w2v(params["wav2vec2"], wavs, wav_lens=lengths)
        return jax.nn.log_softmax(lin(params["ctc_lin"], feats), axis=-1)

    return enc, _JaxModule(
        lambda p, wavs, lengths=None: call(p, jnp.asarray(wavs), lengths),
        _jnp(module_tree(enc)))


def encoder_asr_pair(tmp_path, seed=3):
    """(port ``EncoderASR`` on the CPU, JAX ``EncoderASR``) over the TINY
    CTC encoder, greedy CTC with blank 0, the seeded tokenizer."""
    enc, jenc = tiny_ctc_encoder(seed)
    tok, jtok = tokenizers(tmp_path, CTC_PIECES, seed)
    tface = tpre.EncoderASR(modules={"encoder": enc}, hparams={
        "tokenizer": tok, "decoding_function": functools.partial(
            tctc.ctc_greedy_decode, blank_id=0)}, device="cpu")
    jface = jpre.EncoderASR(modules={"encoder": jenc}, hparams={
        "tokenizer": jtok, "decoding_function": functools.partial(
            jctc.ctc_greedy_decode, blank_id=0)})
    jface.init_params()
    return tface, jface


@pytest.fixture(scope="module")
def asr_pair(tmp_path_factory):
    return encoder_asr_pair(tmp_path_factory.mktemp("tok"))


def test_encoder_asr_matches_jax(asr_pair):
    tface, jface = asr_pair
    wav, lens = _rows(WAVS_SECONDS)
    lp = tface.encode_batch(wav, lens)
    jlp = np.asarray(jface.encode_batch(wav, jnp.asarray(lens)))
    assert lp.shape == jlp.shape == (3, 24, CTC_PIECES)
    np.testing.assert_allclose(lp.numpy(), jlp, atol=ATOL)
    # the argmax of every frame is clear of ties at this tolerance
    top2 = np.sort(jlp, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * ATOL
    words, hyps = tface.transcribe_batch(wav, lens)
    jwords, jhyps = jface.transcribe_batch(wav, jnp.asarray(lens))
    assert hyps == [list(map(int, h)) for h in jhyps] and words == jwords
    assert all(hyps) and all(words)
    # without lengths, every row is whole: relative lengths of ones
    np.testing.assert_array_equal(tface.encode_batch(wav).numpy(),
                                  tface.encode_batch(wav, np.ones(3)).numpy())


TINY_YAML_OVERRIDES = (
    f"arch_overrides: {json.dumps(dict(TINY_ARCH))}\n"
    f"feat_dim: {TINY_ARCH['hidden_size']}\n"
    f"output_neurons: {CTC_PIECES}\n")


def test_encoder_asr_from_hparams_and_transcribe_file(asr_pair, tmp_path):
    tface, jface = asr_pair
    folder = str(tmp_path / "export")
    cs.write_encoder_asr_export(folder, tface.mods.encoder, CTC_PIECES, 3)
    loaded = tpre.EncoderASR.from_hparams(
        folder, savedir=str(tmp_path / "collected"),
        overrides=TINY_YAML_OVERRIDES, device="cpu")
    for name, value in tface.mods.encoder.state_dict().items():
        assert torch.equal(loaded.mods.encoder.state_dict()[name], value)
    # the JAX-shaped tree of the encoder loads back through convert_jax
    fresh = cs.ctc_encoder(TINY_ARCH, CTC_PIECES)
    load_module_tree(fresh, module_tree(tface.mods.encoder))
    for name, value in tface.mods.encoder.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value)
    assert loaded.hparams.tokenizer.pieces == tface.hparams.tokenizer.pieces
    wav, lens = _rows(WAVS_SECONDS, seed=1)
    assert (loaded.transcribe_batch(wav, lens)
            == tface.transcribe_batch(wav, lens))
    path = str(tmp_path / "utt.wav")
    write_audio(path, wav[0], SR)
    audio = np.asarray(read_audio(path))[None]
    words = loaded.transcribe_file(path)
    assert words == loaded.transcribe_batch(audio)[0][0]
    rows = np.zeros_like(wav)
    rows[0] = audio[0]
    assert words == jface.transcribe_batch(rows, jnp.asarray(
        [1.0, 0.5, 0.5], jnp.float32))[0][0]


def tiny_conformer(tmp_path, seed=5):
    """(port ``EncoderDecoderASR``, JAX ``EncoderDecoderASR``) over the
    TINY conformer assembly with a beam search of ``E2E_STEPS`` steps."""
    encoder, parts, _ = cs.conformer_asr_modules(
        seed, E2E_ARCH, E2E_FRONT, E2E_MELS, E2E_PIECES)
    tok, jtok = tokenizers(tmp_path, E2E_PIECES, seed)
    frames = cs.conformer_frames(int(WAVS_SECONDS[0] * SR))
    tface = cs.conformer_interface(encoder, parts, tok, E2E_STEPS, frames,
                                   "cpu", beam=3)
    fbank = jlobes.Fbank(n_mels=E2E_MELS, n_fft=cs.CONFORMER_N_FFT)
    norm = jfeat.InputNormalization(norm_type="global")
    state = {**norm.init_state(), **_jnp(module_tree(
        encoder.normalize, running_stats=True))}
    front = jconv.ConvolutionFrontEnd(input_size=E2E_MELS, **E2E_FRONT)
    asr = jasr.TransformerASR(E2E_PIECES, front.output_dim(), **E2E_ARCH)
    params = {"front": _jnp(module_tree(encoder.frontend)),
              "asr": _jnp(module_tree(encoder.transformer))}

    @jax.jit
    def encode(p, wavs, lengths):
        feats, _ = norm(None, state, fbank(None, wavs), lengths, train=False)
        return asr.encode(p["asr"], front(p["front"], feats), lengths)[0]

    class JittedDecode:
        """The JAX TransformerASR with its step decode jitted (one program a
        prefix length; the eager step costs seconds a call on the CPU)."""
        decode = staticmethod(jax.jit(asr.decode))

    lins = [JLinear(E2E_PIECES, E2E_ARCH["d_model"]) for _ in range(2)]
    searcher = tface.mods.decoder
    jsearcher = jsearch.S2STransformerBeamSearch(
        [JittedDecode()] + lins, [params["asr"]] + [_jnp(module_tree(m))
                                         for m in parts[1:]],
        bos_index=searcher.bos_index, eos_index=searcher.eos_index,
        blank_index=cs.CONFORMER_BLANK, min_decode_ratio=0.0,
        max_decode_ratio=searcher.max_decode_ratio, beam_size=3,
        ctc_weight=cs.CONFORMER_DECODE_CTC)
    jface = jpre.EncoderDecoderASR(
        modules={"encoder": _JaxModule(
            lambda p, wavs, lengths=None: encode(p, jnp.asarray(wavs),
                                                 lengths), params),
                 "decoder": jsearcher}, hparams={"tokenizer": jtok})
    jface.init_params()
    return tface, jface


def test_encoder_decoder_asr_matches_jax(tmp_path):
    tface, jface = tiny_conformer(tmp_path)
    wav, lens = _rows(WAVS_SECONDS, seed=2)
    enc = tface.encode_batch(wav, lens)
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jface.encode_batch(wav, jnp.asarray(lens))),
        atol=ATOL)
    words, hyps = tface.transcribe_batch(wav, lens)
    jwords, jhyps = jface.transcribe_batch(wav, jnp.asarray(lens))
    assert hyps == [list(map(int, h)) for h in jhyps] and words == jwords
    assert all(len(h) == E2E_STEPS for h in hyps)
    path = str(tmp_path / "utt.wav")
    write_audio(path, wav[1], SR)
    audio = np.asarray(read_audio(path))[None]
    assert tface.transcribe_file(path) == jface.transcribe_batch(audio)[0][0]


def vad_pair(seed=7, norm_train=False):
    """(port ``VAD`` on the CPU over the TINY CRDNN with seeded statistics,
    JAX ``VAD`` over the same modules). The JAX normalization is called
    with ``train=False`` unless ``norm_train``, where the JAX ``VAD``'s
    own stateful call (``train`` left at its default) is used."""
    tface, _ = cs.seeded_vad(seed, arch=VAD_ARCH, device="cpu")
    model = tface.mods.model
    crdnn = jcrdnn.CRDNN(**VAD_ARCH)
    lin = JLinear(1, VAD_ARCH["dnn_neurons"])
    crdnn_state = _jnp(module_tree(model, running_stats=True)["0"])
    params = _jnp(module_tree(model))

    @jax.jit
    def classify(p, feats):
        h, _ = crdnn(p["0"], feats, state=crdnn_state)
        return lin(p["1"], h)

    norm = jfeat.InputNormalization(norm_type="global")
    stats = {**norm.init_state(), **_jnp(module_tree(
        tface.mods.mean_var_norm, running_stats=True))}
    if norm_train:
        mean_var_norm = norm
    else:
        normalize = jax.jit(lambda x, lens: norm(None, stats, x, lens,
                                                 train=False)[0])
        mean_var_norm = _JaxModule(lambda p, x, lens=None: normalize(x, lens))
    jface = jpre.VAD(modules={
        "compute_features": jlobes.Fbank(n_mels=VAD_ARCH["input_size"]),
        "mean_var_norm": mean_var_norm,
        "model": _JaxModule(classify, params)},
        hparams={"sample_rate": SR, "time_resolution": 0.01})
    jface.init_params()
    if norm_train:
        jface.states["mean_var_norm"] = dict(stats)
    return tface, jface


def test_vad_matches_jax_with_stored_statistics():
    tface, jface = vad_pair()
    wav = cs.vad_recording(np.random.default_rng(9), 6.0)
    prob = tface.get_speech_prob_chunk(wav)
    jprob = np.asarray(jface.get_speech_prob_chunk(wav))
    assert prob.shape == jprob.shape == (1, 601, 1)
    np.testing.assert_allclose(prob.numpy(), jprob, atol=ATOL)
    # no frame's decision sits within the tolerance of a threshold
    for th in (0.5, 0.25):
        assert np.abs(jprob - th).min() > 10 * ATOL
    np.testing.assert_array_equal(tface.apply_threshold(prob),
                                  jface.apply_threshold(jprob))
    found = 0
    for kw in (dict(double_check=False), dict(double_check=True),
               dict(activation_th=0.7, deactivation_th=0.6, close_th=0.0,
                    len_th=0.0)):
        got = tface.get_speech_segments(wav, **kw)
        np.testing.assert_array_equal(got, jface.get_speech_segments(wav,
                                                                     **kw))
        found += len(got)
    assert found >= 5
    np.testing.assert_array_equal(tface.energy_VAD(wav),
                                  jface.energy_VAD(wav))


def test_vad_keeps_its_statistics_where_the_jax_vad_moves_them():
    tface, jface = vad_pair(norm_train=True)
    wav = cs.vad_recording(np.random.default_rng(9), 3.0)
    norm = tface.mods.mean_var_norm
    loaded = {n: b.clone() for n, b in norm.named_buffers()}
    first = tface.get_speech_prob_chunk(wav)
    second = tface.get_speech_prob_chunk(wav)
    for name, buf in norm.named_buffers():
        assert torch.equal(buf, loaded[name]), name
    assert torch.equal(first, second)
    count = float(jface.states["mean_var_norm"]["count"])
    mean = np.asarray(jface.states["mean_var_norm"]["glob_mean"])
    jface.get_speech_prob_chunk(wav)
    assert float(jface.states["mean_var_norm"]["count"]) == count + 1
    assert not np.array_equal(
        np.asarray(jface.states["mean_var_norm"]["glob_mean"]), mean)
    np.testing.assert_array_equal(mean, loaded["glob_mean"].numpy())


class _Energy(torch.nn.Module):
    """Per-10 ms-frame energy as speech logits (the JAX stub test's)."""

    def forward(self, wavs):
        chunk = SR // 100
        n = wavs.shape[1] // chunk
        fr = wavs[:, :n * chunk].reshape(wavs.shape[0], n, chunk)
        e = fr.square().mean(dim=-1, keepdim=True)
        return torch.where(e > 0.01, 8.0, -8.0)


def test_vad_segments_on_stubs():
    """``tests/test_pretrained_interfaces.py::test_vad_segments`` on the
    port: energy logits, no normalization, the identity model."""
    vad = tpre.VAD(modules={"compute_features": _Energy(),
                            "mean_var_norm": lambda x, lens=None: x,
                            "model": torch.nn.Identity()},
                   hparams={"sample_rate": SR, "time_resolution": 0.01},
                   device="cpu")
    rng = np.random.default_rng(0)
    seg = rng.normal(size=8000).astype(np.float32)
    wav = np.concatenate([seg, np.zeros(8000, np.float32), seg])[None]
    bounds = vad.get_speech_segments(wav, double_check=True)
    assert bounds.shape == (2, 2)
    np.testing.assert_allclose(bounds[0], [0.0, 0.5], atol=0.05)
    np.testing.assert_allclose(bounds[1], [1.0, 1.5], atol=0.05)
    p = np.array([[[0.3], [0.6], [0.3], [0.2], [0.3]]])
    th = vad.apply_threshold(p, activation_th=0.5, deactivation_th=0.25)
    assert th[0, :, 0].tolist() == [0.0, 1.0, 1.0, 0.0, 0.0]
    assert vad.apply_threshold(p[..., 0])[0].tolist() == [0, 1, 1, 0, 0]
    merged = vad.merge_close_segments(np.array([[0.0, 1.0], [1.1, 2.0],
                                                [3.0, 4.0]]), close_th=0.25)
    assert merged.shape == (2, 2) and merged[0].tolist() == [0.0, 2.0]
    kept = vad.remove_short_segments(np.array([[0.0, 0.1], [1.0, 2.0]]),
                                     len_th=0.25)
    assert kept.tolist() == [[1.0, 2.0]]
    assert vad.get_boundaries(th, output_value="frames").tolist() == [
        [1.0, 3.0]]
    assert vad.double_check_speech_segments(
        np.array([[0.0, 0.005]]), torch.from_numpy(wav)).shape == (0, 2)


def test_asr_interfaces_need_cuda_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    hp = {"tokenizer": None, "decoding_function": None, "sample_rate": SR,
          "time_resolution": 0.01}
    for cls, mods in ((tpre.EncoderASR, ["encoder"]),
                      (tpre.EncoderDecoderASR, ["encoder", "decoder"]),
                      (tpre.VAD, ["compute_features", "mean_var_norm",
                                  "model"])):
        with pytest.raises(RuntimeError):
            cls(modules={m: None for m in mods}, hparams=hp)
        face = cls(modules={m: torch.nn.Identity() for m in mods},
                   hparams=hp, device="cpu")
        assert face.device == torch.device("cpu")
        assert not any(m.training for m in vars(face.mods).values())


def test_seeded_unigram_is_a_valid_model(tmp_path):
    tok, jtok = tokenizers(tmp_path, 120, 0)
    assert tok.vocab_size() == jtok.vocab_size() == 120
    assert tok.pieces == jtok.pieces and tok.unk_id() == 0
    for text in cs.SEGMENT_TEXTS:
        ids = tok.encode_as_ids(text)
        assert 0 not in ids and ids == jtok.encode_as_ids(text)
        assert tok.decode_ids(ids) == text
    assert os.path.getsize(tmp_path / "unigram_120.model") > 120

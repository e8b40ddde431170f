"""Port parity, the four interfaces of ``pretrained/interfaces.py`` that serve
the separation, speaker and enhancement models: ``SepformerSeparation``
(a SepFormer masknet and Conv-TasNet's ``MaskNet``; the estimate cut or
zero-padded to the mixture's length), ``EncoderClassifier`` (relative
``wav_lens`` handed to the model as they are, the numpy score and index),
``SpeakerRecognition`` (the numpy cosine, ``verify_files`` on WAVs) and
``SpectralMaskEnhancement`` (log1p magnitudes, the mask, resynthesis with
the noisy phase, ``enhance_file``), each against the JAX interface on the
same weights (the JAX ``init_params``' trees, carried across by
``convert_jax``) and inputs, on the CPU, f32; and the port's interfaces
refuse to run without CUDA unless the CPU is named."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu import pretrained as jpre
from svt_speechbrain_tpu.dataio.dataio import write_audio
from svt_speechbrain_tpu.models import ecapa_tdnn as jecapa
from svt_speechbrain_tpu.models import enhancement as jenh
from svt_speechbrain_tpu.models import features as jfeat
from svt_speechbrain_tpu.models import separation as jsep
from svt_speechbrain_tpu.processing import features as jproc
from svt_speechbrain_tpu.processing import signal_processing as jsig

from svt_speechbrain_tpu_torch import pretrained as tpre
from svt_speechbrain_tpu_torch.convert_jax import load_module_tree
from svt_speechbrain_tpu_torch.models import ecapa_tdnn as tecapa
from svt_speechbrain_tpu_torch.models import enhancement as tenh
from svt_speechbrain_tpu_torch.models import features as tfeat
from svt_speechbrain_tpu_torch.models import separation as tsep
from svt_speechbrain_tpu_torch.processing import features as tproc
from svt_speechbrain_tpu_torch.processing import signal_processing as tsig
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides: separated sources and embeddings of order 0.1-1 and
# cosines within 1e-5 (summation order only); the enhanced waveform is
# peak-normalized to 1 after an STFT, a BLSTM and an ISTFT: 5e-5
ATOL, ATOL_WAV = 1e-5, 5e-5


def _carry(jface, tface):
    """The JAX interface's params loaded into the port's modules."""
    for name, tree in jface.params.items():
        if tree:
            load_module_tree(getattr(tface.mods, name),
                             jax.tree_util.tree_map(np.asarray, tree))


def _wav(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


@pytest.mark.parametrize("masknet,encoder,samples", [
    ("masknet", "tasnet", 1600),      # the decoder gives 1600: equal
    ("masknet", "tasnet", 1605),      # 1600 from 1605: zero-padded
    ("dual_path", "tasnet", 1601),
    ("masknet", "conv_tasnet", 1600)])  # "same" frames give 1616: cut
def test_sepformer_separation(masknet, encoder, samples):
    def modules(pkg):
        enc = (pkg.TasNetEncoder(16, 32) if encoder == "tasnet"
               else pkg.ConvTasNetEncoder(16, 32))
        if masknet == "masknet":
            net = pkg.MaskNet(32, 16, 32, 3, n_blocks=2, n_repeats=1,
                              n_sources=2)
        else:
            net = pkg.Dual_Path_Model(
                32, 16, pkg.SBTransformerBlock(1, 16, 4, 32, True, True),
                pkg.SBTransformerBlock(1, 16, 4, 32, True, True), K=20,
                linear_layer_after_inter_intra=False)
        return {"encoder": enc, "masknet": net,
                "decoder": pkg.TasNetDecoder(16, 32)}

    jface = jpre.SepformerSeparation(modules=modules(jsep), hparams={})
    jface.init_params(seed=0)
    tface = tpre.SepformerSeparation(modules=modules(tsep), hparams={},
                                     device="cpu")
    _carry(jface, tface)
    mix = _wav((2, samples))
    got = tface.separate_batch(mix)
    assert got.shape == (2, samples, 2)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jface.separate_batch(mix)),
                               atol=ATOL)


ECAPA = dict(input_size=16, lin_neurons=12, channels=(16, 16, 16, 16, 48),
             attention_channels=8, res2net_scale=4, se_channels=8)


def _speaker(pkg, classifier):
    feats = jfeat if pkg is jecapa else tfeat
    mods = {"compute_features": feats.Fbank(n_mels=16),
            "embedding_model": pkg.ECAPA_TDNN(**ECAPA)}
    if classifier:
        mods["classifier"] = pkg.Classifier(12, 12, 7)
    return mods


def test_encoder_classifier():
    jface = jpre.EncoderClassifier(modules=_speaker(jecapa, True),
                                   hparams={})
    jface.init_params(seed=1)
    tface = tpre.EncoderClassifier(modules=_speaker(tecapa, True),
                                   hparams={}, device="cpu")
    _carry(jface, tface)
    wavs = _wav((3, 4000))
    lens = np.asarray([1.0, 0.8, 0.5], np.float32)   # relative, unrounded
    np.testing.assert_allclose(tface.encode_batch(wavs, lens).numpy(),
                               np.asarray(jface.encode_batch(wavs, lens)),
                               atol=ATOL)
    out, score, index = tface.classify_batch(wavs, lens)
    jout, jscore, jindex = jface.classify_batch(wavs, lens)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(score, jscore, atol=ATOL)
    np.testing.assert_array_equal(index, jindex)
    assert isinstance(score, np.ndarray) and isinstance(index, np.ndarray)


def test_speaker_recognition(tmp_path):
    jface = jpre.SpeakerRecognition(modules=_speaker(jecapa, False),
                                    hparams={})
    jface.init_params(seed=2)
    tface = tpre.SpeakerRecognition(modules=_speaker(tecapa, False),
                                    hparams={}, device="cpu")
    _carry(jface, tface)
    w1, w2 = _wav((3, 4000), 1), _wav((3, 4000), 2)
    l1 = np.asarray([1.0, 0.7, 0.9], np.float32)
    l2 = np.asarray([0.6, 1.0, 0.8], np.float32)
    score, decision = tface.verify_batch(w1, w2, l1, l2, threshold=0.5)
    jscore, jdecision = jface.verify_batch(w1, w2, l1, l2, threshold=0.5)
    np.testing.assert_allclose(score, jscore, atol=ATOL)
    np.testing.assert_array_equal(decision, jdecision)
    paths = []
    for i, w in enumerate((w1[0], w2[1])):
        paths.append(str(tmp_path / f"{i}.wav"))
        write_audio(paths[-1], w, 16000)
    got, want = tface.verify_files(*paths), jface.verify_files(*paths)
    assert abs(got[0] - want[0]) <= ATOL and got[1] == want[1]


def _enhancement_hparams(proc, sig):
    stft = proc.STFT(16000, win_length=32, hop_length=16, n_fft=512)
    istft = proc.ISTFT(16000, win_length=32, hop_length=16, n_fft=512)
    return {"compute_stft": stft,
            "spectral_magnitude": functools.partial(proc.spectral_magnitude,
                                                    power=0.5),
            "resynth": functools.partial(sig.resynthesize, stft=stft,
                                         istft=istft)}


def test_spectral_mask_enhancement(tmp_path):
    jface = jpre.SpectralMaskEnhancement(
        modules={"enhance_model": jenh.EnhancementGenerator(257, 8, 1)},
        hparams=_enhancement_hparams(jproc, jsig))
    jface.init_params(seed=3)
    tface = tpre.SpectralMaskEnhancement(
        modules={"enhance_model": tenh.EnhancementGenerator(257, 8, 1)},
        hparams=_enhancement_hparams(tproc, tsig), device="cpu")
    _carry(jface, tface)
    noisy = _wav((2, 4000))
    np.testing.assert_allclose(
        tface.compute_features(noisy).numpy(),
        np.asarray(jface.compute_features(jnp.asarray(noisy))), atol=ATOL)
    got = tface.enhance_batch(noisy)
    assert got.shape == noisy.shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jface.enhance_batch(noisy)),
                               atol=ATOL_WAV)
    src, out = str(tmp_path / "noisy.wav"), str(tmp_path / "enhanced.wav")
    write_audio(src, noisy[0], 16000)
    np.testing.assert_allclose(
        tface.enhance_file(src, output_path=out).numpy(),
        np.asarray(jface.enhance_file(src)), atol=ATOL_WAV)
    assert (tmp_path / "enhanced.wav").stat().st_size > 44


def test_interfaces_need_cuda_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError):
        tpre.SepformerSeparation(modules={"encoder": None, "masknet": None,
                                          "decoder": None}, hparams={})
    face = tpre.SpeakerRecognition(modules=_speaker(tecapa, False),
                                   hparams={}, device="cpu")
    assert face.device == torch.device("cpu")
    assert all(p.device.type == "cpu"
               for p in face.mods.embedding_model.parameters())


SLICE = ["models/separation.py", "models/ecapa_tdnn.py", "models/xvector.py",
         "models/enhancement.py", "models/contextnet.py",
         "models/transformer_se_st.py", "nnet/complex_networks.py",
         "nnet/quaternion_networks.py"]


def _public_names(path):
    """Top-level public classes, functions and assignments of a file, read
    with ``ast`` (no import)."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", SLICE + ["models/convert_sb.py",
                                         "pretrained/interfaces.py"])
def test_public_names_of_the_slice(rel):
    """Every public name of the eight modules exists in the port; of
    ``convert_sb`` the three speaker and separation converters and
    ``_conv1d``; of ``pretrained/interfaces.py`` the four interfaces (the
    ASR ones and ``VAD`` are held by ``tests/test_torch_isolation.py::
    test_public_names_of_item20``)."""
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    want = _public_names(repo / "svt_speechbrain_tpu" / rel)
    got = _public_names(repo / "svt_speechbrain_tpu_torch" / rel)
    if rel == "models/convert_sb.py":
        want = {"convert_xvector", "convert_ecapa", "convert_dual_path"}
        assert "_conv1d" in (repo / "svt_speechbrain_tpu_torch" /
                             rel).read_text()
    elif rel == "pretrained/interfaces.py":
        want = {"EncoderClassifier", "SpeakerRecognition",
                "SepformerSeparation", "SpectralMaskEnhancement"}
    assert sorted(want - got) == []

"""The port stands alone, the later slices: separation, speaker and
enhancement, pretraining and parallelism, and item 20's back-ends and
interfaces run in a fresh interpreter without loading JAX or the JAX
package; their modules' public names."""
import os
import subprocess
import sys

import pytest

from tests.test_torch_isolation import (  # noqa: F401
    PORT, REPO, _public_names)


_SEP_SPK_ENH_PROBE = """
import sys
import numpy as np
import torch
import chip_smoke as cs
from svt_speechbrain_tpu_torch import pretrained
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.models import (contextnet, convert_sb,
                                              ecapa_tdnn, enhancement,
                                              separation, transformer_se_st,
                                              xvector)
from svt_speechbrain_tpu_torch.nnet import (complex_networks,
                                            quaternion_networks)
rng = np.random.default_rng(0)
arch = dict(cs.SEP_ARCH, num_layers=1, tlayers=1, nhead=2, d_ffn=16, K=10)
sep = cs.sepformer_brain(cs.sepformer_modules(arch, 8, 8), "cpu", 0)
assert np.isfinite(sep.fit_batch(cs.sepformer_batch(rng, 1, 200)))
face = pretrained.SepformerSeparation(modules=dict(sep.modules.items()),
                                      hparams={}, device="cpu")
assert face.separate_batch(np.zeros((1, 205), np.float32)).shape == (1, 205, 2)
spk = dict(cs.ECAPA_ARCH, input_size=12, lin_neurons=6,
           channels=(8, 8, 8, 8, 24), attention_channels=4, res2net_scale=4,
           se_channels=4)
mods = cs.ecapa_modules(spk, 5)
mods["compute_features"] = cs.Fbank(n_mels=12)
brain = cs.ecapa_brain(mods, "cpu", 0)
wav, lens = cs.speech_rows(rng, (0.3, 0.2))
batch = {"sig": cs.PaddedData(torch.from_numpy(wav), lens),
         "spk_id": torch.tensor([1, 4])}
assert np.isfinite(brain.fit_batch(batch))
score, _ = pretrained.SpeakerRecognition(
    modules=dict(brain.modules.items()), hparams={},
    device="cpu").verify_batch(wav, wav[::-1], lens, lens[::-1])
assert score.shape == (2,)
enh = {"enhance_model": enhancement.EnhancementGenerator(257, 4, 1)}
init_modules(enh, 0)
out = pretrained.SpectralMaskEnhancement(
    modules=enh, hparams=cs.metricgan_hparams(),
    device="cpu").enhance_batch(wav)
assert out.shape == wav.shape
for name, make, inputs, call, grads in cs._rest_cases():
    cs._rest_run(make, inputs(rng), call, "cpu", torch.float32, 0, False)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_separation_speaker_enhancement_slice_runs_without_loading_jax():
    """The separation, speaker and enhancement slice (the eight modules,
    their converters, the four interfaces and phases 24-25's assemblies and
    ``Brain``s) imports, takes TINY training steps, serves each interface
    and runs phase 25's small set on the CPU without loading JAX or the JAX
    package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _SEP_SPK_ENH_PROBE],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


_PRETRAIN_PARALLEL_PROBE = """
import sys
import numpy as np
import torch
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.models import avhubert, convert_fairseq
from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH, Wav2Vec2Config
from svt_speechbrain_tpu_torch.models.wav2vec2_pretrain import (
    HuggingFaceWav2Vec2Pretrain, Wav2Vec2Pretrain)
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from svt_speechbrain_tpu_torch.parallel import (distributed, fsdp, mesh,
                                                pipeline, tp)
from svt_speechbrain_tpu_torch.utils import orbax_checkpoints
from svt_speechbrain_tpu_torch.dataio.sampler import DistributedSamplerWrapper
model = Wav2Vec2Pretrain(Wav2Vec2Config(**TINY_ARCH), codevector_dim=16,
                         num_negatives=4)
init_modules({"model": model}, 0)
mask, negs = model.sample_masks(2, 49, np.random.default_rng(0))
opt = torch.optim.Adam(model.parameters(), lr=1e-3)
rng = StepRNG(torch.Generator().manual_seed(0), torch.Generator().manual_seed(0))
loss, aux = model(torch.randn(2, 16000), mask, negs, rng=rng, train=True)
loss.backward()
opt.step()
assert np.isfinite(loss.item()) and len(aux) == 3
cfg = avhubert.AVHubertConfig(encoder_layers=1, encoder_embed_dim=16,
                              encoder_ffn_embed_dim=32,
                              encoder_attention_heads=4, audio_feat_dim=10,
                              conv_pos=8, conv_pos_groups=2)
av = avhubert.AVHubertPretrain(cfg, num_classes=5, final_dim=8)
init_modules({"av": av}, 0)
loss, _ = av({"audio": torch.randn(2, 20, 10)},
             torch.zeros(2, 20, dtype=torch.long), av.sample_masks(2, 20))
assert np.isfinite(loss.item())
assert list(DistributedSamplerWrapper(range(5), 1, 2)) == [1, 3, 0]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_pretraining_and_parallel_modules_run_without_loading_jax():
    """The pretraining models and the parallel layer import, and a TINY
    ``Wav2Vec2Pretrain`` Adam step and an ``AVHubertPretrain`` forward run
    on the CPU, without loading JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _PRETRAIN_PARALLEL_PROBE],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


_ITEM20_PROBE = """
import sys
import tempfile
import numpy as np
import torch
from svt_speechbrain_tpu_torch.alignment import aligner, ctc_segmentation
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.dataio.dataio import merge_char, split_word
from svt_speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from svt_speechbrain_tpu_torch.lm import arpa, counting, ngram
from svt_speechbrain_tpu_torch.models.beamform_multimic import (
    DelaySum_Beamformer)
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    TINY_ARCH, HuggingFaceWav2Vec2, Wav2Vec2Config, Wav2Vec2CTCEncoder)
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.pretrained.interfaces import (
    VAD, EncoderASR, EncoderDecoderASR)
from svt_speechbrain_tpu_torch.processing import (
    decomposition, diarization, multi_mic, nmf, plda_lda)
from svt_speechbrain_tpu_torch.tokenizers import (
    sentence_piece, spm_lite, spm_proto)
path = tempfile.mkdtemp() + "/tok.model"
pieces = [("<unk>", 0.0, 2)] + [(c, -2.0, 1) for c in "▁abc"]
open(path, "wb").write(spm_proto.write_model(pieces, unk_id=0))
tok = spm_lite.SentencePieceProcessor()
tok.load(path)
enc = Wav2Vec2CTCEncoder(HuggingFaceWav2Vec2(config=Wav2Vec2Config(
    **TINY_ARCH)), Linear(len(pieces), TINY_ARCH["hidden_size"]))
init_modules({"encoder": enc}, 0)
import functools
asr = EncoderASR(modules={"encoder": enc}, hparams={
    "tokenizer": tok, "decoding_function": functools.partial(
        ctc_greedy_decode, blank_id=0)}, device="cpu")
words, hyps = asr.transcribe_batch(np.zeros((2, 8000), np.float32),
                                   np.array([1.0, 0.5], np.float32))
assert len(words) == len(hyps) == 2
wav = torch.randn(1, 4000, 3)
assert DelaySum_Beamformer(16000, tdoa_max=8)(wav).shape == (1, 4000)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_item20_slice_runs_without_loading_jax():
    """The tokenizers, language models, alignment, multi-mic and speaker
    back-ends and the ASR and VAD interfaces import, and a TINY
    ``EncoderASR.transcribe_batch`` and a ``DelaySum_Beamformer`` call run
    on the CPU, without loading JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _ITEM20_PROBE],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


ITEM20 = ["processing/multi_mic.py", "processing/decomposition.py",
          "processing/nmf.py", "processing/plda_lda.py",
          "processing/diarization.py", "models/beamform_multimic.py",
          "alignment/aligner.py", "alignment/ctc_segmentation.py",
          "lm/arpa.py", "lm/counting.py", "lm/ngram.py",
          "tokenizers/sentence_piece.py", "tokenizers/spm_lite.py",
          "tokenizers/spm_proto.py", "pretrained/interfaces.py"]


@pytest.mark.parametrize("rel", ITEM20)
def test_public_names_of_item20(rel):
    """Every public name of the fifteen JAX modules of ROADMAP.md item 20
    exists in the port's module (``pretrained/interfaces.py`` with its
    three ASR and VAD interfaces, so all of it)."""
    want = _public_names(REPO / "svt_speechbrain_tpu" / rel)
    got = _public_names(PORT / rel)
    assert sorted(want - got) == []


@pytest.mark.parametrize("rel", [
    "models/wav2vec2_pretrain.py", "models/avhubert.py",
    "models/convert_fairseq.py", "parallel/distributed.py",
    "parallel/mesh.py", "parallel/fsdp.py", "parallel/tp.py",
    "parallel/pipeline.py", "utils/orbax_checkpoints.py",
    "dataio/sampler.py"])
def test_public_names_of_the_pretraining_and_parallel_modules(rel):
    """Every public name of the JAX modules of SSL pretraining and of
    parallelism beyond one device exists in the port's module."""
    want = _public_names(REPO / "svt_speechbrain_tpu" / rel)
    got = _public_names(PORT / rel)
    assert sorted(want - got) == []

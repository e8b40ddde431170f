"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never continue on the CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "svt_speechbrain_tpu_torch"

_PROBE = """
import sys
import torch
from svt_speechbrain_tpu_torch.flagship import build_flagship
from svt_speechbrain_tpu_torch.inference import (
    BatchedAMTTranscriber, StreamingAMTTranscriber, StreamingServer)
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT
from svt_speechbrain_tpu_torch.models import convert_hf, quantize
from svt_speechbrain_tpu_torch.ops import quant
from svt_speechbrain_tpu_torch.pretrained.interfaces import SingingTranscriber
from svt_speechbrain_tpu_torch.utils import transcription_eval
from svt_speechbrain_tpu_torch.decoders import TransducerBeamSearcher
from svt_speechbrain_tpu_torch.nnet import embedding, rnn, transducer_joint
from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import TransducerLoss
from svt_speechbrain_tpu_torch.ops import transducer_lattice
from svt_speechbrain_tpu_torch import config, core
from svt_speechbrain_tpu_torch.dataio import (batch, dataio, dataloader,
                                             dataset, sampler)
from svt_speechbrain_tpu_torch.nnet import schedulers
from svt_speechbrain_tpu_torch.parallel import distributed
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import (prepare_benchmarks,
                                                        train_audio_ssl)
from svt_speechbrain_tpu_torch.utils import (checkpoints, epoch_loop, logger,
                                             metric_stats, train_logger)
from svt_speechbrain_tpu_torch.processing import signal_processing
from svt_speechbrain_tpu_torch.models import fusion, transformer
from svt_speechbrain_tpu_torch.tasks.amt import FusionAMT
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only import (
    extract_ssl_feats, prepare_benchmarks as n20em_benchmarks,
    prepare_n20emv2, train_audio_ssl as n20em_audio)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual import (
    prepare_musan, prepare_n20emv2 as av_prep, run_noise_sweep,
    synthesis_noise, train_rca_a, train_rca_av)
from svt_speechbrain_tpu_torch.pretrained import fetching
from svt_speechbrain_tpu_torch.dataio import (encoder, iterators, legacy,
                                             preprocess, wer)
from svt_speechbrain_tpu_torch.utils import (callchains, edit_distance,
                                             parameter_transfer, superpowers)
rca = quantize.quantize_fusion(fusion.FusionRCA(0.5, 4, 32, 16),
                               quantize_attn=True)
with torch.no_grad():
    assert rca(torch.ones(1, 5, 16), torch.ones(1, 6, 16)).shape == (1, 5, 16)
assert signal_processing.mix_at_snr(torch.ones(4), torch.ones(4), 0).shape \
    == (4,)
model = build_flagship(tiny=True, device="cpu")
with torch.no_grad():
    outs = model(torch.zeros(1, 8000))
assert outs[2].shape == (1, 24, 5), outs[2].shape
iface = SingingTranscriber(
    modules={"wav2vec2": model.bridge, "model": model.head},
    hparams={"frame_rate": 49.8, "onset_threshold": 0.4,
             "offset_threshold": 0.5},
    batch_size=2, chunk_seconds=0.5, quantize="int8", device="cpu")
session = iface.serve(batch_size=2).open()
notes = session.feed(torch.zeros(12000).numpy()) + session.flush()
assert all(len(ev) == 3 for ev in notes)
logits = torch.zeros(1, 3, 2, 4, requires_grad=True)
TransducerLoss(blank_index=0, fused=True)(
    logits, torch.ones(1, 1, dtype=torch.long), torch.ones(1),
    torch.ones(1)).backward()
assert logits.grad.abs().sum() > 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_port_runs_without_loading_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


_SEQ2SEQ_PROBE = """
import sys
import torch
from svt_speechbrain_tpu_torch.decoders import (
    CTCPrefixScorer, FairseqSequenceGenerator, S2SBeamSearcher,
    S2SGreedySearcher, ctc_greedy_decode)
from svt_speechbrain_tpu_torch.decoders import ctc, fairseq_generator, seq2seq
from svt_speechbrain_tpu_torch.models import (avhubert_asr, convert_fairseq,
                                              seq2seq_decoder)
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.nnet.loss import guidedattn_loss, si_snr_loss
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.models.avhubert import AVHubertConfig
asr = avhubert_asr.AVHubertASR(
    AVHubertConfig(encoder_layers=1, encoder_embed_dim=16,
                   encoder_ffn_embed_dim=32, encoder_attention_heads=2,
                   audio_feat_dim=8),
    seq2seq_decoder.FairseqDecoderConfig(vocab_size=13, embed_dim=16,
                                         ffn_dim=32, num_layers=1,
                                         num_heads=2),
    beam_size=2, max_len_b=4)
init_modules({"asr": asr}, seed=0)
hyps = asr.transcribe(audio=torch.ones(1, 6, 8), device_search=True)
assert int(hyps[0][0]["tokens"][-1]) == 2
logp = torch.log_softmax(torch.randn(2, 5, 4), -1)
loss = losses.ctc_loss(logp, torch.ones(2, 2, dtype=torch.long),
                       torch.ones(2), torch.ones(2), 0)
assert torch.isfinite(loss)
scorer = CTCPrefixScorer(logp, [5, 4], 2, 1, 0, 3)
psi, _ = scorer.forward_step(torch.zeros(2, 0, dtype=torch.long), None)
assert psi.shape == (2, 4)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_seq2seq_slice_runs_without_loading_jax():
    """The seq2seq decoding slice (the fairseq decoder and generator,
    ``AVHubertASR``, the CTC and speechbrain searchers, the losses) imports
    and runs a TINY decode without loading JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _SEQ2SEQ_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


_CRDNN_PROBE = """
import sys
import numpy as np
import torch
import chip_smoke as cs
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models import crdnn, features
from svt_speechbrain_tpu_torch.nnet import (activations, attention, cnn,
                                            containers, dropout, linear,
                                            normalization, pooling, rnn)
from svt_speechbrain_tpu_torch.processing import features as proc
arch = dict(cs.CRDNN_ARCH, input_size=16, cnn_channels=(4, 6), rnn_layers=1,
            rnn_neurons=8, dnn_neurons=10)
dec = dict(cs.CRDNN_DEC, hidden_size=9, attn_dim=7, kernel_size=4)
brain = cs.crdnn_brain(cs.crdnn_modules(arch, dec, 11, 6), "cpu", 0)
batch = cs.crdnn_batch(np.random.default_rng(0), (0.3, 0.2), 11)
assert np.isfinite(brain.fit_batch(batch))
with torch.no_grad():
    p_ctc, p_seq = brain.compute_forward(brain._batch_to_device(batch),
                                         Stage.VALID)
assert p_ctc.shape == (2, 15, 11) and torch.isfinite(p_seq).all()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_crdnn_slice_runs_without_loading_jax():
    """The CRDNN slice (the rest of ``nnet/``, the features, the CRDNN and
    phase 22's assembly and ``Brain``) imports and takes a TINY training
    step without loading JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _CRDNN_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


_CONFORMER_PROBE = """
import sys
import numpy as np
import torch
import chip_smoke as cs
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.decoders import seq2seq
from svt_speechbrain_tpu_torch.models import (augment, conformer, convert_sb,
                                              convolution, rnnlm,
                                              transformer, transformer_asr)
from svt_speechbrain_tpu_torch.nnet.loss import stoi_loss
from svt_speechbrain_tpu_torch.processing import speech_augmentation
arch = dict(cs.CONFORMER_ARCH, d_model=8, nhead=2, num_encoder_layers=1,
            num_decoder_layers=1, d_ffn=16, kernel_size=3)
front = dict(cs.CONFORMER_FRONT, out_channels=(2, 3))
brain = cs.conformer_brain(cs.conformer_modules(arch, front, 12, 11), "cpu",
                           0)
batch = cs.conformer_batch(np.random.default_rng(0), (0.3, 0.2), 11)
assert np.isfinite(brain.fit_batch(batch))
arrays = brain._batch_to_device(batch)
with torch.no_grad():
    enc, _ = brain.modules.asr.encode(brain.features(arrays, Stage.VALID),
                                      arrays["sig"].lengths)
hyps, scores = cs.conformer_searcher(brain.modules, 3, enc.shape[1],
                                     beam=2)(enc, arrays["sig"].lengths)
assert len(hyps) == 2 and all(np.isfinite(scores))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_conformer_slice_runs_without_loading_jax():
    """The conformer slice (augmentation, the transformer and conformer
    stacks, ``TransformerASR``, the searchers, the STOI loss, the SpeechBrain
    converters and phase 23's assembly and ``Brain``) imports, takes a TINY
    augmented training step and beam-decodes without loading JAX or the JAX
    package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _CONFORMER_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


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


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|svt_speechbrain_tpu)"
    r"(?![\w])", re.MULTILINE)


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []


def test_import_pattern_tells_the_packages_apart():
    assert _IMPORT.search("from svt_speechbrain_tpu.nnet import x")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from svt_speechbrain_tpu_torch.nnet import x")


def test_entry_points_raise_without_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from svt_speechbrain_tpu_torch import resolve_device
    from svt_speechbrain_tpu_torch.flagship import build_flagship

    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_flagship(tiny=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_brain_raises_without_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from svt_speechbrain_tpu_torch.core import Brain
    from svt_speechbrain_tpu_torch.nnet.linear import Linear
    from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT

    for cls in (Brain, AudioAMT):
        with pytest.raises(RuntimeError):
            cls({"model": Linear(2, 2)})
        with pytest.raises(RuntimeError):
            cls({"model": Linear(2, 2)}, run_opts={"precision": "bf16"})
        assert cls({"model": Linear(2, 2)},
                   run_opts={"device": "cpu"}).device == torch.device("cpu")


_WITHOUT_YAML_OR_TQDM = """
import sys
sys.modules["yaml"] = None      # an import of any now raises ImportError
sys.modules["msgpack"] = None
sys.modules["tqdm"] = None
import tempfile
import numpy as np
import torch
import chip_smoke
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models.wav2vec2 import (HuggingFaceWav2Vec2,
                                                      TINY_ARCH)
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import train_audio_ssl
root = tempfile.mkdtemp()
csvs = chip_smoke.make_recipe_set(root, np.random.default_rng(0), {
    "train": (6, 7), "valid": (6,), "test": (6,)})
hp = chip_smoke.recipe_hparams(
    data_folder=root, output_folder=root + "/out", train_csv=csvs["train"],
    valid_csv=csvs["valid"], test_csv=[csvs["test"]], num_workers=2,
    batch_size=2, feat_dim=64, wav2vec2=HuggingFaceWav2Vec2(
        source="tiny-test", arch_overrides=TINY_ARCH))
train, valid, tests = train_audio_ssl.dataio_prepare(hp)
brain = train_audio_ssl.AMT(modules=hp["modules"], hparams=hp,
                            run_opts={"device": "cpu"},
                            checkpointer=hp["checkpointer"])
brain.init_optimizers()
brain.on_stage_start(Stage.TRAIN, 1)
loss = brain.fit_batch(next(iter(brain.make_dataloader(
    train, Stage.TRAIN, **hp["train_dataloader_opts"]))))
brain.on_stage_start(Stage.VALID, 1)
eval_loss = brain.evaluate_batch(next(iter(brain.make_dataloader(
    valid, Stage.VALID, **hp["valid_dataloader_opts"]))), Stage.VALID)
assert np.isfinite(loss) and np.isfinite(eval_loss), (loss, eval_loss)
loaded = [m.split(".")[0] for m in sys.modules if sys.modules[m]]
assert "yaml" not in loaded and "msgpack" not in loaded
print("FIT-AND-EVALUATE-OK", loss, eval_loss)
"""


def test_engine_and_recipe_run_without_yaml_or_tqdm():
    """The engine, the data loading and the recipe import and run one TINY
    training step and one evaluated utterance, through loader worker
    processes, with PyYAML, msgpack and tqdm unavailable (the card machine
    need not have them): the recipe's objects come from ``chip_smoke.py``'s
    Python hparams."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _WITHOUT_YAML_OR_TQDM],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FIT-AND-EVALUATE-OK" in res.stdout, res.stdout


_DEPLOY_WITHOUT_PACKAGES = """
import json, os, shutil, sys, tempfile
sys.modules["yaml"] = None      # an import of any now raises ImportError
sys.modules["msgpack"] = None
sys.modules["tqdm"] = None
import numpy as np
import torch
from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import load_msgpack
from svt_speechbrain_tpu_torch.dataio.dataio import write_audio
from svt_speechbrain_tpu_torch.flagship import build_flagship
from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH
from svt_speechbrain_tpu_torch.pretrained.interfaces import SingingTranscriber
from svt_speechbrain_tpu_torch.tasks.amt import save_state_dict
tiny = ("wav2vec2: !new:svt_speechbrain_tpu_torch.models.wav2vec2."
        "HuggingFaceWav2Vec2 {source: tiny-test, arch_overrides: "
        + json.dumps(dict(TINY_ARCH)) + "}\\nfeat_dim: 64\\n")
root = tempfile.mkdtemp()
with open("svt_speechbrain_tpu_torch/recipes/MIR_ST500/hparams/"
          "train_audio_ssl.yaml") as f:
    hp = load_hyperyaml(f, "data_folder: " + root + "\\n" + tiny)
assert hp["modules"]["wav2vec2"].config.hidden_size == 64
model = build_flagship(tiny=True, device="cpu")
export = os.path.join(root, "export")
os.makedirs(export)
shutil.copy("tests/fixtures/singing_transcriber_hyperparams.yaml",
            os.path.join(export, "hyperparams.yaml"))
save_state_dict(model.bridge, os.path.join(export, "wav2vec2.pt"))
save_state_dict(model.head, os.path.join(export, "model.pt"))
wav = os.path.join(root, "song.wav")
write_audio(wav, 0.1 * np.random.default_rng(0).standard_normal(24000)
            .astype(np.float32), 16000)
face = SingingTranscriber.from_hparams(
    export, savedir=os.path.join(root, "saved"), overrides=tiny,
    device="cpu", batch_size=2, chunk_seconds=1.0)
notes = face.transcribe_file(wav)
assert all(len(ev) == 3 for ev in notes)
tree = load_msgpack("tests/fixtures/jax_export_small.msgpack")
assert tree["model"]["w"].shape == (16, 20)
loaded = [m.split(".")[0] for m in sys.modules if sys.modules[m]]
assert "yaml" not in loaded and "msgpack" not in loaded
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("DEPLOY-OK", len(notes), bad)
"""


def test_deployment_runs_without_yaml_or_msgpack():
    """``load_hyperyaml`` of a recipe yaml, a TINY ``from_hparams`` on the
    inference yaml of ``tests/fixtures/`` with ``transcribe_file``, and the
    small JAX export read by ``load_msgpack``, with PyYAML, msgpack and tqdm
    unavailable and without loading JAX: the port reads both formats with
    its own readers."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _DEPLOY_WITHOUT_PACKAGES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DEPLOY-OK" in res.stdout and res.stdout.rstrip().endswith(
        "[]"), res.stdout

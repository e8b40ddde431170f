"""The port stands alone, the ASR slices and the last modules: the seq2seq,
CRDNN and conformer slices, and the native reader, the loader over a batch
sampler and the last utility modules, run in a fresh interpreter without
loading JAX or the JAX package; the item-21 modules' public names."""
import os
import subprocess
import sys

import pytest

from tests.test_torch_isolation import (  # noqa: F401
    PORT, REPO, _public_names)


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


_ITEM21_PROBE = """
import os, sys, tempfile
import numpy as np
import torch
from svt_speechbrain_tpu_torch import native
from svt_speechbrain_tpu_torch.dataio import batch, dataio, dataloader, sampler
from svt_speechbrain_tpu_torch.utils import (accuracy, bleu, data_utils, der,
                                             epoch_loop, flops, hpopt, logger,
                                             profiling)
from svt_speechbrain_tpu_torch.models.wav2vec2 import Wav2Vec2Config
assert native.get_lib() is not None
path = native.library_path()
assert path.parent == native.BUILD_DIR and path.exists(), path
wav = os.path.join(tempfile.mkdtemp(), "a.wav")
dataio.write_audio(wav, np.zeros(800), 16000)
assert dataio.read_audio(wav).shape == (800,)
data = [{"id": f"u{i}", "x": np.zeros(i + 1, np.float32)} for i in range(4)]
loader = dataloader.SaveableDataLoader(
    data, batch_sampler=sampler.DynamicBatchSampler(
        None, 4, num_buckets=2, lengths_list=[1, 2, 3, 4], shuffle=False),
    prefetch_batches=4, unknown_key=1)
assert sum(len(b.id) for b in loader) == 4
assert accuracy.Accuracy(torch.zeros(1, 2, 3), torch.zeros(1, 2,
                                                          dtype=torch.long))
assert flops.amt_train_flops(Wav2Vec2Config(), 16000) > 0
timer = profiling.StepTimer()
with timer.measure(device="cpu"), profiling.annotate("x"):
    pass
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_item21_modules_run_without_loading_jax():
    """The native reader, the repaired loader over a batch sampler and the
    last utility modules import and run without loading JAX or the JAX
    package; the native library is built into ``build/native/`` and never
    beside its source."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _ITEM21_PROBE],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout
    beside = {p.name for p in (PORT / "native").iterdir()} - {"__pycache__"}
    assert beside == {"__init__.py", "wav_loader.cpp"}
    assert (REPO / "build" / "native").is_dir()
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored


# JAX names with no port by design (docs/PORT_MAP.md)
ITEM21 = {"native/__init__.py": set(), "dataio/dataio.py": set(),
          "dataio/batch.py": set(), "dataio/dataloader.py": set(),
          "core.py": {"enable_compile_cache"},
          "utils/data_utils.py": {"download_file"},
          "utils/epoch_loop.py": set(), "utils/logger.py": set(),
          "utils/checkpoints.py": set(), "utils/accuracy.py": set(),
          "utils/bleu.py": set(), "utils/der.py": set(),
          "utils/hpopt.py": set(), "utils/flops.py": {"DEFAULT_PEAK_TFLOPS"},
          "utils/profiling.py": {"log_compile_cache_stats"}}


@pytest.mark.parametrize("rel", sorted(ITEM21))
def test_public_names_of_item21(rel):
    """Every public name of the JAX modules of ROADMAP.md item 21 exists in
    the port's module, but the names the module map leaves out."""
    want = _public_names(REPO / "svt_speechbrain_tpu" / rel)
    got = _public_names(PORT / rel)
    assert sorted(want - got - ITEM21[rel]) == []
    assert ITEM21[rel] <= want

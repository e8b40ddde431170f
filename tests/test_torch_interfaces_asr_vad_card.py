"""The ASR and VAD interfaces and the back-ends of ROADMAP.md item 20 on the
card, at TINY widths: ``EncoderASR`` over a TINY lv60 whose frontend the
CUDA kernel takes (64 channels) launches row 1 seven times and row 2 once a
layer in a batch and in a ``CTCSegmentation`` call, and ``chip_smoke.py``'s
phase 27 (f) — the CTC encoder's log-posteriors, a conformer encoder's
states, the VAD's posteriors, the beamformers, localizers and ``gevd``,
and ``HMMAligner``'s scores and alignments — card against CPU in f64,
within ``chip_smoke.TOL_F64`` (1e-9), directions and alignments equal.

Card-only: every test carries the ``cuda`` marker and skips without a CUDA
device. The file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_interfaces_asr_vad_card.py
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.alignment.ctc_segmentation import (
    CTCSegmentation)
from svt_speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH
from svt_speechbrain_tpu_torch.pretrained.interfaces import EncoderASR

pytestmark = pytest.mark.cuda

TINY64 = dict(TINY_ARCH, conv_dim=(64,) * 7)
PIECES = 80


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the card vs CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_encoder_asr_launches_rows_1_and_2(cuda_device, tmp_path):
    enc = cs.ctc_encoder(TINY64, PIECES)
    cs._seeded({"encoder": enc}, 3)
    tok = cs.seeded_unigram(str(tmp_path / "tok.model"), PIECES, 3)
    asr = EncoderASR(modules={"encoder": enc}, hparams={
        "tokenizer": tok, "decoding_function": functools.partial(
            ctc_greedy_decode, blank_id=0)}, device="cuda")
    wav, lens = cs.speech_rows(np.random.default_rng(0), (1.0, 0.8, 0.6))
    want = {"conv_frontend": 7, "flash_attention_short": 2}
    ops.reset_launch_counts()
    words, hyps = asr.transcribe_batch(wav, lens)
    cs.expect_counts(ops.launch_counts(), want, "a TINY EncoderASR batch")
    assert len(words) == len(hyps) == 3
    lp = asr.encode_batch(wav, lens)
    assert bool(torch.isfinite(lp).all())
    # the bridge's switch takes the frontend off its kernel, and only it
    enc.wav2vec2.fused_frontend = False
    ops.reset_launch_counts()
    plain = asr.encode_batch(wav, lens)
    cs.expect_counts(ops.launch_counts(), {"flash_attention_short": 2},
                     "an encode_batch with fused_frontend=False")
    assert plain.shape == lp.shape
    enc.wav2vec2.fused_frontend = True
    ops.reset_launch_counts()
    task = CTCSegmentation(asr)(wav[:1], ["the cat", "sat on"])
    cs.expect_counts(ops.launch_counts(), want, "a CTCSegmentation call")
    assert len(task.segments) == 2


def test_phase27_card_vs_cpu_f64_at_tiny_widths(cuda_device):
    res = cs.interfaces_card_vs_cpu(
        np.random.default_rng(0), ctc_arch=dict(cs.CTC_F64_ARCH, **TINY64),
        conformer=dict(
            arch=dict(cs.CONFORMER_ARCH, d_model=16, nhead=2,
                      num_encoder_layers=2, num_decoder_layers=1, d_ffn=32,
                      kernel_size=7, dropout=0.0),
            front=dict(cs.CONFORMER_FRONT, out_channels=(4, 4)), n_mels=20,
            vocab=60),
        vad_arch=dict(cs.VAD_ARCH, input_size=16, cnn_channels=(3, 4),
                      rnn_neurons=6, dnn_neurons=5),
        crdnn=dict(arch=dict(cs.CRDNN_ARCH, cnn_channels=(4, 8),
                             rnn_layers=2, rnn_neurons=16, dnn_blocks=1,
                             dnn_neurons=16),
                   dec=dict(cs.CRDNN_DEC, hidden_size=8, attn_dim=8,
                            channels=2, kernel_size=5),
                   vocab=cs.CRDNN_VOCAB, emb=8))
    assert all(v <= cs.TOL_F64 for v in res["errs"].values())
    assert all(res["same"].values())
